"""The likelihood kernel's least time (``card.lut_bound``: N particles,
the on-map ones' windows of R u8 or u16 entries and row-map entries,
each byte once; the tabled beam terms) over its device time a launch
(profiler rows named ``lut_loglik_kernel``), in %. Nothing where the
profile's rows fall short of the launches the wrapper counted."""

from mcl_bench.card import lut_bound


def read(run):
    prof, s = run.profile, run.shapes
    if not prof or not prof["complete"] or not prof["lut_rows"]:
        return None
    ms = prof["lut_us"] / 1e3 / prof["lut_rows"]
    b = lut_bound(s["n"], s["n_on"], s["beams"], s["itemsize"], s["row_map"])
    return 100.0 * b["bound_ms"] / ms
