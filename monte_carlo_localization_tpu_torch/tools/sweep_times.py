"""Device times of a checkout's range-LUT sweep kernel at the LUT
geometries ``chip_smoke.py``'s ``lut_build`` builds on the card, so that
two commits can be compared on one card in one run:

    python monte_carlo_localization_tpu_torch/tools/sweep_times.py [--root DIR] [--repeat N]

Run it as a file, not with ``-m``: ``--root`` (default: the checkout that
holds this file) is the checkout whose package is imported and timed, and
any checkout of the port since its LUT builders came to the card works.
It prints the card's name and power limit, then one JSON line per
geometry: the sweep kernel's device ms a build (``utils/timing.py``
``device_ms``, the profiler's median of three runs of two builds, times
the build's launches), the launches, the build's bound (the LUT bytes it
writes at 3.35 TB/s) and a checksum of the LUT's bytes (equal checksums
from two checkouts: the same LUT). The whole-map compact builds also give
the wall of ``GridMap.with_compact_range_lut`` (``lut_build_s``, the best
of ``--repeat``) beside the host's part of it timed alone: the clearance
field and the row map.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
U16_RANGE_M = 25.6  # the u16 golden trace's range (BENCHES.md)


def _checksum(lut) -> list[int]:
    """(sum of the bytes, sum of every 4099th byte times its index): equal
    for equal LUTs, and moved by nearly any difference."""
    import torch

    flat = lut.reshape(-1).view(torch.uint8)
    total = sum(int(c.sum(dtype=torch.int64)) for c in flat.split(1 << 30))
    sample = flat[::4099].to(torch.int64)
    weighted = int((sample * torch.arange(1, sample.numel() + 1, device=flat.device)).sum())
    return [total, weighted]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    parser.add_argument("--repeat", type=int, default=3)
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("sweep_times: no CUDA device", file=sys.stderr)
        return 2
    import monte_carlo_localization_tpu_torch as pkg
    from monte_carlo_localization_tpu_torch import load_map
    from monte_carlo_localization_tpu_torch.mapping import clearance_field
    from monte_carlo_localization_tpu_torch.mapping.range_lut import lut_dtype
    from monte_carlo_localization_tpu_torch.mapping.range_lut_device import (
        FAR_ROW_MARGIN,
        build_compact_range_lut_device,
        build_range_lut_device,
        compact_row_map,
    )
    from monte_carlo_localization_tpu_torch.ops._cuda_build import load_library
    from monte_carlo_localization_tpu_torch.ops.lut_query import (
        required_row_stride,
        suggest_theta_bins,
    )
    from monte_carlo_localization_tpu_torch.ops.range_lut_sweep import sweep
    from monte_carlo_localization_tpu_torch.parallel import stack_maps
    from monte_carlo_localization_tpu_torch.utils.timing import device_ms

    if Path(pkg.__file__).resolve().parents[1] != root:
        print(f"sweep_times: imported {pkg.__file__}, not the package of {root}", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    built = load_library()
    dev = torch.device("cuda", 0)
    maps = root / "maps"

    def beams_of(trace: str) -> np.ndarray:
        with np.load(root / "traces" / trace) as z:
            return np.asarray(z["beam_angles"], np.float32)[::18]

    def headline_beams(n: int) -> np.ndarray:
        inc = 1.5 * np.pi / max(n - 1, 1)
        return (-0.75 * np.pi + np.arange(n) * inc).astype(np.float32)

    def geometry(beams, mrp):
        itemsize = lut_dtype(mrp).itemsize
        t = suggest_theta_bins(beams)
        return t, required_row_stride(t, beams, itemsize)

    def report(name: str, build, extra: dict | None = None) -> None:
        before = sweep.launch_count
        lut = build()
        torch.cuda.synchronize()
        launches = sweep.launch_count - before
        nbytes = lut.numel() * lut.element_size()
        check = _checksum(lut)
        del lut
        dev_ms = device_ms(build, "range_lut_sweep_kernel", iters=2)
        torch.cuda.empty_cache()
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(json.dumps({
            "geometry": name, "card": card, "root": str(root), "launches": launches,
            "sweep_ms_per_launch": dev_ms["ms"], "sweep_ms_per_build": dev_ms["ms"] * launches,
            "time_source": dev_ms["source"], "lut_bytes": nbytes, "write_bound_ms": bound,
            "x_bound": dev_ms["ms"] * launches / bound, "checksum": check, **(extra or {}),
        }), flush=True)

    def whole_map_wall(gm, t, stride) -> dict:
        """lut_build_s of the card route, best of --repeat, and the host's
        part of it alone: the occupancy to the host, the clearance field and
        the row map."""
        walls = []
        for _ in range(args.repeat):
            walls.append(gm.with_compact_range_lut(t, stride).lut_build_s)
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        occ = gm.occupied.cpu().numpy()
        t1 = time.perf_counter()
        clr = clearance_field(occ, gm.max_range_px + FAR_ROW_MARGIN + 2)
        t2 = time.perf_counter()
        compact_row_map(clr, gm.max_range_px)
        t3 = time.perf_counter()
        return dict(lut_build_s=min(walls), lut_build_s_all=walls, host_occupied_s=t1 - t0,
                    host_clearance_s=t2 - t1, host_row_map_s=t3 - t2)

    gm1 = load_map(maps / "map_1753950572.yaml", device=dev)
    t1, s1 = geometry(beams_of("config1_map_1753950572.npz"), gm1.max_range_px)
    for name, stride in (("config1_dense_T", t1), ("config1_dense_padded", s1)):
        report(name, lambda s=stride: build_range_lut_device(gm1.occupied, t1, gm1.max_range_px, s))

    spiel = load_map(maps / "Spielberg_map.yaml", device=dev)
    beams = headline_beams(1080)
    free = spiel.free_cells[: spiel.num_free].float().median(dim=0).values.long().tolist()
    r0 = min(max(free[0] - 200, 0), spiel.height - 400)
    c0 = min(max(free[1] - 200, 0), spiel.width - 400)
    crop = spiel.occupied[r0:r0 + 400, c0:c0 + 400].contiguous()
    for name, range_m in (("crop_compact_u8", 12.0), ("crop_compact_u16", U16_RANGE_M)):
        mrp = int(range_m / spiel.resolution)
        t, stride = geometry(beams, mrp)
        clr = clearance_field(crop.cpu().numpy(), mrp + FAR_ROW_MARGIN + 2)
        report(name, lambda t=t, s=stride, m=mrp, c=clr: build_compact_range_lut_device(
            crop, c, t, m, s, lut_dtype=lut_dtype(m))[0])
    t, stride = geometry(beams, spiel.max_range_px)
    clr = clearance_field(spiel.occupied.cpu().numpy(), spiel.max_range_px + FAR_ROW_MARGIN + 2)
    report("spielberg_compact_u8", lambda: build_compact_range_lut_device(
        spiel.occupied, clr, t, spiel.max_range_px, stride,
        lut_dtype=lut_dtype(spiel.max_range_px))[0], whole_map_wall(spiel, t, stride))
    report("spielberg_dense_1440",
           lambda: build_range_lut_device(spiel.occupied, 1440, spiel.max_range_px, 1440))
    del spiel, crop, clr
    torch.cuda.empty_cache()

    for name, trace, range_m in (("basement_u8", "config4_basement_fixed.npz", 12.0),
                                 ("basement_u16", "u16_basement.npz", U16_RANGE_M)):
        gm = load_map(maps / "basement_fixed.map.yaml", max_range_meters=range_m, device=dev)
        t, stride = geometry(beams_of(trace), gm.max_range_px)
        clr = clearance_field(gm.occupied.cpu().numpy(), gm.max_range_px + FAR_ROW_MARGIN + 2)
        report(name, lambda g=gm, t=t, s=stride, c=clr: build_compact_range_lut_device(
            g.occupied, c, t, g.max_range_px, s, lut_dtype=lut_dtype(g.max_range_px))[0],
            whole_map_wall(gm, t, stride))
        del gm, clr
        torch.cuda.empty_cache()

    fleet = stack_maps([load_map(maps / n, device=dev) for n in (
        "map_1753950572.yaml", "icra_2_clean.yaml", "first_map.yaml", "new_map1.yaml")])
    t, stride = geometry(headline_beams(60), fleet.max_range_px)
    eps = 512 // lut_dtype(fleet.max_range_px).itemsize
    report("config5_member_compact",
           lambda: fleet.with_member_compact_luts(t, stride, eps).range_lut)
    report("config5_member_dense",
           lambda: fleet.with_member_luts(t, stride, eps, use_cache=False).range_lut)
    print(json.dumps({"done": True, "nvcc_s": built.seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
