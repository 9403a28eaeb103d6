"""Command-line interface of the PyTorch/CUDA port, with the JAX package's
arguments and JSON lines (``monte_carlo_localization_tpu/cli.py``), plus
``--device`` (default ``cuda``; without a card a default call raises).

Subcommands:
  replay      run a recorded trace through the engine, report RMSE/rates
  live        replay a trace in REAL TIME through the dual-rate LiveRunner
  make-trace  synthesize a golden trace by driving a simulated car in a map
  info        inspect a map or trace file (``--lut``: build the map's range
              LUT and print its route and seconds)
  export-bag  trace .npz -> rosbag2 directory (sqlite3 + CDR)
  import-bag  rosbag2 directory (or .db3) -> trace .npz
  baseline    replay a trace through the measured CPU reference harness
              (``baseline/cpu_reference.py``, on the host CPU)
  bench       the benchmark harness (``bench.py`` of this package; its
              own arguments, ``--device`` among them)

``replay --viz-out DIR`` renders PNG frames (Pillow); ``live --serve PORT``
serves the interactive viewer over HTTP (``runtime/webviz.py``).

``--raycast`` takes every method of the JAX package: ``auto`` and
``lut_pallas`` (the fused LUT kernel), ``lut``, ``sphere`` and ``dda``.

Map resolution: ``--map`` accepts either a path to a ROS-style map YAML or
a bare name resolved against ``--map-dir``.

    python -m monte_carlo_localization_tpu_torch.cli replay \\
        --map maps/map_1753950572.yaml \\
        --trace traces/config1_map_1753950572.npz --particles 4000
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from monte_carlo_localization_tpu_torch.config import MCLConfig, load_config
from monte_carlo_localization_tpu_torch.mapping import load_map
from monte_carlo_localization_tpu_torch.runtime import (
    JsonlSink,
    LiveRunner,
    MCLNode,
    NpzSink,
    Trace,
    TraceReader,
    VizSink,
    WebViz,
    load_state,
    save_state,
    synthesize_trace,
)
from monte_carlo_localization_tpu_torch.runtime.rosbag import export_bag, import_bag
from monte_carlo_localization_tpu_torch.utils.timing import device_trace

def _resolve_map(map_arg: str, map_dir: str | None, max_range: float, device: str):
    p = Path(map_arg)
    if p.suffix in (".yaml", ".yml") and p.exists():
        return load_map(p, max_range_meters=max_range, device=device)
    if map_dir:
        candidate = Path(map_dir) / f"{map_arg}.yaml"
        if candidate.exists():
            return load_map(candidate, max_range_meters=max_range, device=device)
    raise SystemExit(f"map not found: {map_arg!r} (map_dir={map_dir!r})")


def _load_cfg(args) -> MCLConfig:
    cfg = load_config(args.config) if args.config else MCLConfig()
    overrides = {}
    if args.particles is not None:
        overrides["max_particles"] = args.particles
    if getattr(args, "angle_step", None) is not None:
        overrides["angle_step"] = args.angle_step
    if getattr(args, "raycast", None):
        overrides["raycast_method"] = args.raycast
    if getattr(args, "resample", None):
        overrides["resample_method"] = args.resample
    if getattr(args, "async_correction", False):
        overrides["async_correction"] = True
    if getattr(args, "live_chunk", None) is not None:
        overrides["live_chunk"] = args.live_chunk
        if args.live_chunk > 1 and not overrides.get("async_correction"):
            # chunking only exists on the async dispatch path; a bare
            # --live-chunk K unambiguously asks for it
            overrides["async_correction"] = True
    return cfg.replace(**overrides) if overrides else cfg


def cmd_make_trace(args) -> int:
    if args.duration <= 0:
        raise SystemExit("--duration must be positive")
    if args.beams <= 0:
        raise SystemExit("--beams must be positive")
    gm = _resolve_map(args.map, args.map_dir, args.max_range, args.device)
    t0 = time.perf_counter()
    trace = synthesize_trace(
        gm,
        duration_s=args.duration,
        num_beams=args.beams,
        seed=args.seed,
        speed=args.speed,
    )
    written = trace.save(args.out)
    print(
        f"wrote {written}: {trace.scan_ranges.shape[0]} scans x "
        f"{trace.num_beams} beams, {len(trace.odom_t)} odom msgs, "
        f"{trace.duration:.1f}s sim ({time.perf_counter() - t0:.1f}s wall)"
    )
    return 0


def _make_sink(path: str):
    if path.endswith(".jsonl"):
        return JsonlSink(path)
    if path.endswith(".npz"):
        return NpzSink(path)
    raise SystemExit(f"--record-out must end in .jsonl or .npz: {path!r}")


def _resume(node: MCLNode, trace: Trace, path: str) -> None:
    node.state, meta = load_state(path, tracker=node.tracker, device=node.device)
    node.iters = int(meta.get("iters", 0))
    if meta.get("inferred_pose") is not None:
        node.inferred_pose = np.asarray(meta["inferred_pose"])
    node.on_scan(trace.scan_ranges[0], beam_angles=trace.beam_angles)


def _checkpoint(node: MCLNode, path: str) -> None:
    save_state(
        path, node.state,
        iters=node.iters, inferred_pose=node.inferred_pose,
        tracker=node.tracker,
    )


def cmd_replay(args) -> int:
    cfg = _load_cfg(args)
    gm = _resolve_map(args.map, args.map_dir, args.max_range, args.device)
    trace = Trace.load(args.trace)
    log = print if args.verbose else (lambda s: None)
    node = MCLNode(gm, cfg, log=log)
    if args.record_out:
        node.add_sink(_make_sink(args.record_out))
    if args.viz_out:
        node.add_sink(VizSink(gm, args.viz_out, every=args.viz_every))
    if args.resume_from:
        _resume(node, trace, args.resume_from)
    elif args.init == "truth" and trace.truth_pose is not None:
        node.initialize_pose(trace.truth_pose[0])
    # --init global: the node starts globally initialized
    run = node.replay_chained if args.chained else node.replay
    if args.profile_dir:
        with device_trace(args.profile_dir, log=log):
            res = run(trace)
    else:
        res = run(trace)
    lut_map = node.filter.grid_map
    if lut_map.lut_route:
        log(f"range LUT built by {lut_map.lut_route} in {lut_map.lut_build_s:.3f} s")
    if args.checkpoint_out:
        _checkpoint(node, args.checkpoint_out)
    node.close_sinks()
    out = dict(
        corrections=len(res.times),
        updates_per_sec=round(res.updates_per_sec, 2),
        rmse_xy_m=None if res.rmse_xy is None else round(res.rmse_xy, 4),
        rmse_theta_rad=None if res.rmse_theta is None else round(res.rmse_theta, 4),
        particles=cfg.max_particles,
        beams=int(np.ceil(trace.num_beams / cfg.angle_step)),
        map=gm.name,
    )
    if args.record_out:
        out["record_out"] = args.record_out
    print(json.dumps(out))
    return 0


def cmd_live(args) -> int:
    """Feed a trace through the node in REAL TIME: odometry/scans arrive at
    their recorded wall-clock rates on the main thread while the LiveRunner
    ticks at timer_frequency on its own thread — the reference's dual-rate
    process topology."""
    cfg = _load_cfg(args)
    gm = _resolve_map(args.map, args.map_dir, args.max_range, args.device)
    trace = Trace.load(args.trace)
    node = MCLNode(gm, cfg, log=print if args.verbose else (lambda s: None))
    if args.record_out:
        node.add_sink(_make_sink(args.record_out))
    if args.resume_from:
        _resume(node, trace, args.resume_from)
    elif trace.truth_pose is not None:
        node.initialize_pose(trace.truth_pose[0])

    webviz = None
    if args.serve is not None:
        webviz = WebViz(node, gm, port=args.serve).start()
        print(f"# live viewer at {webviz.url}", flush=True)

    duration = args.duration or min(trace.duration, 10.0)
    t0 = time.monotonic()
    with LiveRunner(node) as runner:
        for ev in TraceReader(trace):
            if ev.t > duration:
                break
            lag = ev.t - (time.monotonic() - t0)
            if lag > 0:
                time.sleep(lag)
            if ev.kind == "odom":
                op, tw = trace.odom_pose[ev.index], trace.odom_twist[ev.index]
                node.on_odometry(op[0], op[1], op[2], tw[0], tw[1], stamp=ev.t)
            else:
                node.on_scan(
                    trace.scan_ranges[ev.index], beam_angles=trace.beam_angles
                )
        wall = time.monotonic() - t0
    if webviz is not None:
        webviz.close()
    if args.checkpoint_out:
        _checkpoint(node, args.checkpoint_out)
    node.close_sinks()
    print(
        json.dumps(
            dict(
                wall_s=round(wall, 2),
                ticks=runner.ticks,
                corrections=runner.corrections,
                skipped_ticks=runner.skipped,
                tick_hz=round(runner.ticks / wall, 1),
                correction_hz=round(runner.corrections / wall, 1),
                timer_frequency=cfg.timer_frequency,
            )
        )
    )
    return 0


def cmd_info(args) -> int:
    p = Path(args.path)
    if p.suffix == ".npz":
        t = Trace.load(p)
        print(
            json.dumps(
                dict(
                    kind="trace",
                    map=t.map_name,
                    duration_s=round(t.duration, 2),
                    scans=int(t.scan_ranges.shape[0]),
                    beams=int(t.num_beams),
                    odom_msgs=int(len(t.odom_t)),
                    has_truth=t.truth_t is not None,
                )
            )
        )
    else:
        gm = _resolve_map(str(p), args.map_dir, 12.0, args.device)
        out = dict(
            kind="map",
            name=gm.name,
            height=gm.height,
            width=gm.width,
            resolution=gm.resolution,
            origin=[float(gm.origin_x), float(gm.origin_y), float(gm.origin_yaw)],
            free_cells=gm.num_free_cells,
            max_range_px=gm.max_range_px,
        )
        if args.lut:
            # the `lut` method's dense LUT, built where the map lives
            gm = gm.with_range_lut(args.lut_theta_bins, use_cache=False)
            out.update(lut_theta_bins=gm.lut_theta_bins, lut_route=gm.lut_route,
                       lut_build_s=gm.lut_build_s,
                       lut_bytes=gm.range_lut.numel() * gm.range_lut.element_size())
        print(json.dumps(out))
    return 0


def cmd_export_bag(args) -> int:
    """Trace .npz -> rosbag2 directory (sqlite3 + CDR; no ROS install)."""
    t = Trace.load(args.trace)
    out = export_bag(
        t, args.out,
        scan_topic=args.scan_topic, odom_topic=args.odom_topic,
        truth_topic=args.truth_topic, range_max=args.range_max,
    )
    print(json.dumps(dict(
        bag=str(out),
        scans=int(t.scan_ranges.shape[0]),
        odom_msgs=int(len(t.odom_t)),
        has_truth=t.truth_t is not None,
    )))
    return 0


def cmd_import_bag(args) -> int:
    """rosbag2 directory (or bare .db3) -> trace .npz for ``replay``."""
    t = import_bag(
        args.bag,
        scan_topic=args.scan_topic, odom_topic=args.odom_topic,
        truth_topic=args.truth_topic, map_name=args.map_name,
    )
    p = t.save(args.out)
    print(json.dumps(dict(
        trace=str(p),
        scans=int(t.scan_ranges.shape[0]),
        beams=int(t.num_beams),
        odom_msgs=int(len(t.odom_t)),
        has_truth=t.truth_t is not None,
        duration_s=round(t.duration, 2),
    )))
    return 0


def cmd_baseline(args) -> int:
    """The CPU reference harness on a trace; it runs on the host by
    design, so its map is loaded on the CPU and it takes no ``--device``."""
    from monte_carlo_localization_tpu_torch.baseline import (
        replay_cpu_reference,
        trajectory_rmse,
    )

    gm = _resolve_map(args.map, args.map_dir, args.max_range, "cpu")
    trace = Trace.load(args.trace)
    cfg = _load_cfg(args)
    times, poses, stats, ups = replay_cpu_reference(
        gm, trace, cfg, seed=0, max_corrections=args.corrections
    )
    out = dict(
        engine="cpu_reference",
        updates_per_sec=round(ups, 2),
        corrections=len(times),
        particles=cfg.max_particles,
    )
    if trace.truth_t is not None:
        rx, rt = trajectory_rmse(times, poses, trace.truth_t, trace.truth_pose)
        out["rmse_xy_m"] = round(rx, 4)
        out["rmse_theta_rad"] = round(rt, 4)
    n = max(stats.measurement_count, 1)
    out["phase_ms"] = dict(
        total=round(stats.total_mcl_time / n, 2),
        raycast=round(stats.ray_casting_time / n, 2),
        sensor=round(stats.sensor_model_time / n, 2),
        query_prep=round(stats.query_prep_time / n, 2),
        motion=round(stats.motion_model_time / n, 2),
        resample=round(stats.resampling_time / n, 2),
    )
    print(json.dumps(out))
    return 0


def cmd_bench(argv: list[str]) -> int:
    from monte_carlo_localization_tpu_torch import bench

    return bench.main(argv)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="monte_carlo_localization_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    device = argparse.ArgumentParser(add_help=False)
    device.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; cpu for a "
                        "machine without a card)")

    map_args = argparse.ArgumentParser(add_help=False)
    map_args.add_argument("--map", required=True, help="map YAML path or name")
    map_args.add_argument("--map-dir", default=None)
    map_args.add_argument("--max-range", type=float, default=12.0)
    common = argparse.ArgumentParser(add_help=False, parents=[device, map_args])

    mt = sub.add_parser("make-trace", parents=[common])
    mt.add_argument("--out", required=True)
    mt.add_argument("--duration", type=float, default=20.0)
    mt.add_argument("--beams", type=int, default=1080)
    mt.add_argument("--speed", type=float, default=1.5)
    mt.add_argument("--seed", type=int, default=0)
    mt.set_defaults(fn=cmd_make_trace)

    rp = sub.add_parser("replay", parents=[common])
    rp.add_argument("--trace", required=True)
    rp.add_argument("--config", default=None, help="mcl_config.yaml")
    rp.add_argument("--particles", type=int, default=None)
    rp.add_argument("--angle-step", type=int, default=None, dest="angle_step")
    rp.add_argument(
        "--raycast",
        choices=["auto", "lut_pallas", "lut", "sphere", "dda"],
        default=None,
    )
    rp.add_argument(
        "--resample", choices=["systematic", "multinomial"], default=None
    )
    rp.add_argument("--init", choices=["truth", "global"], default="truth")
    rp.add_argument("--viz-out", default=None, dest="viz_out",
                    help="directory for rendered PNG frames (RViz analogue)")
    rp.add_argument("--viz-every", type=int, default=10, dest="viz_every",
                    help="render every Nth correction (default 10)")
    rp.add_argument("--record-out", default=None, dest="record_out",
                    help="stream outputs to a .jsonl or .npz sink")
    rp.add_argument(
        "--chained", action="store_true",
        help="chain corrections on the device (step_many) — throughput path; "
        "skips the dual-rate tracker and per-correction sinks",
    )
    rp.add_argument("--checkpoint-out", default=None, dest="checkpoint_out",
                    help="write the final filter/tracker state (npz)")
    rp.add_argument("--resume-from", default=None, dest="resume_from",
                    help="resume from a checkpoint instead of --init")
    rp.add_argument("--profile-dir", default=None, dest="profile_dir",
                    help="write a torch.profiler Chrome trace of the replay "
                    "into this directory")
    rp.add_argument("-v", "--verbose", action="store_true")
    rp.set_defaults(fn=cmd_replay)

    lv = sub.add_parser("live", parents=[common])
    lv.add_argument("--trace", required=True)
    lv.add_argument("--config", default=None, help="mcl_config.yaml")
    lv.add_argument("--particles", type=int, default=None)
    lv.add_argument("--angle-step", type=int, default=None, dest="angle_step")
    lv.add_argument(
        "--raycast",
        choices=["auto", "lut_pallas", "lut", "sphere", "dda"],
        default=None,
    )
    lv.add_argument("--duration", type=float, default=None,
                    help="seconds of trace to feed (default: min(trace, 10))")
    lv.add_argument("--record-out", default=None, dest="record_out")
    lv.add_argument("--async-correction", action="store_true",
                    dest="async_correction",
                    help="pipeline corrections: dispatch without blocking, "
                    "harvest poses as the device finishes")
    lv.add_argument("--live-chunk", type=int, default=None, dest="live_chunk",
                    help="with --async-correction: buffer K ticks and "
                    "dispatch them as one step_many(K) (1 = off)")
    lv.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="serve the interactive live viewer (map + cloud "
                    "+ pose; drag to set a pose estimate, button for "
                    "global re-init) on this port (0 = ephemeral)")
    lv.add_argument("--checkpoint-out", default=None, dest="checkpoint_out",
                    help="write the final filter/tracker state (npz) when "
                    "the live window ends")
    lv.add_argument("--resume-from", default=None, dest="resume_from",
                    help="resume the filter/tracker from a checkpoint "
                    "instead of seeding from the trace's first truth pose")
    lv.add_argument("-v", "--verbose", action="store_true")
    lv.set_defaults(fn=cmd_live, resample=None)

    bl = sub.add_parser("baseline", parents=[map_args],
                        help="the measured CPU baseline: the reference-faithful "
                        "host harness (numpy + native DDA) on the host CPU")
    bl.add_argument("--trace", required=True)
    bl.add_argument("--config", default=None)
    bl.add_argument("--particles", type=int, default=None)
    bl.add_argument("--angle-step", type=int, default=None, dest="angle_step")
    bl.add_argument("--corrections", type=int, default=60,
                    help="cap on replayed corrections (timing sample size)")
    bl.set_defaults(fn=cmd_baseline, raycast=None, resample=None)

    # listed for the usage only: main() hands bench its arguments unparsed
    sub.add_parser("bench", help="the benchmark harness (python -m "
                   "monte_carlo_localization_tpu_torch.bench --help)")

    eb = sub.add_parser(
        "export-bag",
        help="trace .npz -> rosbag2 directory (ros2-bag-play compatible)",
    )
    eb.add_argument("--trace", required=True)
    eb.add_argument("--out", required=True, help="bag directory to create")
    eb.add_argument("--scan-topic", default="/scan")
    eb.add_argument("--odom-topic", default="/odom")
    eb.add_argument("--truth-topic", default="/ground_truth")
    eb.add_argument("--range-max", type=float, default=30.0)
    eb.set_defaults(fn=cmd_export_bag)

    ib = sub.add_parser(
        "import-bag",
        help="rosbag2 directory/.db3 -> trace .npz (feeds `replay`)",
    )
    ib.add_argument("--bag", required=True)
    ib.add_argument("--out", required=True)
    ib.add_argument("--scan-topic", default=None,
                    help="default: first LaserScan topic in the bag")
    ib.add_argument("--odom-topic", default=None,
                    help="default: first Odometry topic in the bag")
    ib.add_argument("--truth-topic", default=None,
                    help="default: second Odometry topic if present")
    ib.add_argument("--map-name", default="")
    ib.set_defaults(fn=cmd_import_bag)

    inf = sub.add_parser("info", parents=[device])
    inf.add_argument("path")
    inf.add_argument("--map-dir", default=None)
    inf.add_argument("--lut", action="store_true",
                     help="build the map's dense range LUT (on the card with --device "
                     "cuda) and print which route built it and its seconds")
    inf.add_argument("--lut-theta-bins", type=int, default=1440, dest="lut_theta_bins")
    inf.set_defaults(fn=cmd_info)

    return ap


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["bench"]:
        # the harness parses its own options (an argparse remainder would
        # hand the leading ones to this parser)
        return cmd_bench(argv[1:])
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
