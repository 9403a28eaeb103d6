"""The feasibility probes of the JAX package's ``tools/mega_probe.py`` as
Hopper kernels (``csrc/probes.cu``), each beside its plain PyTorch version.

Each TPU probe checked one capability the mega-fused step needed; each
kernel here computes what its probe computes, designed for the card:

- :meth:`Probes.gather_rows`: ``out[s] = hbm[y0[s]]`` with the offsets
  staged in shared memory and the rows copied by ``cp.async``
  (``probe_smem``).
- :meth:`Probes.philox_normals`: Philox4x32-10 normals by Box-Muller,
  the stream running on across blocks (``probe_rng``).
- :meth:`Probes.staged_writes`: every block writes its slice of a staging
  buffer, and the block that draws the last grid-wide ticket reads it all
  back (``probe_scratch``, ``probe_smem_roundtrip``).
- :meth:`Probes.scan_resample`: the mega step's prologue and its parts
  (``probe_cumsum``, ``probe_mega_ops``, ``probe_mega_parts``,
  ``probe_mega_bisect``), chosen by ``part`` (:data:`SCAN_PARTS`).

A :class:`Probes` object launches the kernel on CUDA tensors (adding one
to its ``launch_count`` entry) and runs the plain version on CPU tensors.
"""

from __future__ import annotations

import math

import torch

# what probe_scan_resample computes, by part (csrc/probes.cu)
SCAN_PARTS = {"scan": 0, "lanes": 1, "roll": 2, "ge_sum": 3, "gather": 4, "col": 5,
              "front": 6, "full": 7}
MAX_SCAN = 1024 * 8  # elements of one probe_scan_resample block
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def _lib():
    from monte_carlo_localization_tpu_torch.ops._cuda_build import load_library

    built = load_library()
    return built, built.libs["probes"]


def _check(built, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({built.error_string(err)})")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _require(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{name} dtype {t.dtype}, the kernel takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# ---- plain versions ------------------------------------------------------


def gather_rows_reference(hbm: torch.Tensor, y0: torch.Tensor) -> torch.Tensor:
    """``out[s] = hbm[y0[s]]``."""
    return hbm[y0.long()]


def _mulhilo32(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``a`` and
    the uint32 values ``b`` (held in int64), by 16-bit limbs so no int64
    product overflows."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    b_hi, b_lo = b >> 16, b & 0xFFFF
    t = ((a_hi * b_lo + a_lo * b_hi) << 16) + a_lo * b_lo  # < 2^50
    return (a_hi * b_hi + (t >> 32)) & _MASK32, t & _MASK32


def philox4x32_10_reference(counters: torch.Tensor, key: tuple[int, int]) -> torch.Tensor:
    """Philox4x32-10 of (M, 4) uint32 counters (in int64) under ``key``:
    (M, 4) uint32 words in int64, as Random123's ``philox4x32_10``."""
    c = [counters[:, i].to(torch.int64) for i in range(4)]
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for r in range(10):
        if r > 0:
            k0, k1 = (k0 + PHILOX_W[0]) & _MASK32, (k1 + PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo32(PHILOX_M[0], c[0])
        hi1, lo1 = _mulhilo32(PHILOX_M[1], c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return torch.stack(c, dim=1)


def box_muller_reference(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The probe's float32 Box-Muller of two uint32 words (in int64)."""
    u1 = (b1 >> 8).to(torch.float32) * (1.0 / (1 << 24))
    u2 = (b2 >> 8).to(torch.float32) * (1.0 / (1 << 24))
    r = torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-12)))
    return r * torch.cos(float(torch.tensor(2.0 * math.pi, dtype=torch.float32)) * u2)


def philox_normals_reference(seed: tuple[int, int], count: int, device="cpu"):
    """(normals (count,) float32, words (count / 2, 4) int64): pair q takes
    counter (q, 0, 0, 0); words 0-1 make normal 2q, words 2-3 normal 2q+1."""
    if count % 2:
        raise ValueError(f"count {count} must be even (normals come in pairs)")
    q = torch.arange(count // 2, dtype=torch.int64, device=device)
    ctr = torch.stack([q & _MASK32, q >> 32, torch.zeros_like(q), torch.zeros_like(q)], 1)
    words = philox4x32_10_reference(ctr, seed)
    normals = torch.stack(
        [box_muller_reference(words[:, 0], words[:, 1]),
         box_muller_reference(words[:, 2], words[:, 3])], 1,
    )
    return normals.reshape(-1), words


def staged_writes_reference(steps: int, per_step: int, a: float, b: float, c: float,
                            add: float, device="cpu") -> torch.Tensor:
    """``stage[i, s] = a*i + b*s + c`` read back as ``stage + add``, flat."""
    i = torch.arange(steps, dtype=torch.float32, device=device)[:, None]
    s = torch.arange(per_step, dtype=torch.float32, device=device)[None, :]
    return (a * i + b * s + c + add).reshape(-1)


def _search_left(g: torch.Tensor) -> torch.Tensor:
    """For slots 0..n-1: the first j with g[j] >= slot (n if none)."""
    slots = torch.arange(g.shape[0], dtype=torch.float32, device=g.device)
    return torch.searchsorted(g.contiguous(), slots, side="left")


def _ancestors(g: torch.Tensor, parts: torch.Tensor) -> torch.Tensor:
    j = _search_left(g)
    n = g.shape[0]
    picked = parts[torch.clamp(j, max=n - 1)]
    return torch.where((j < n)[:, None], picked, torch.zeros_like(picked))


def scan_resample_reference(part: str, w=None, g=None, parts=None, u0: float = 0.0,
                            lanes: int = 128):
    """Plain version of ``probe_scan_resample`` (:data:`SCAN_PARTS`): scans
    in float64 rounded to float32, the ancestor search by
    ``torch.searchsorted(side="left")``. Returns out_a, or (out_a, out_b)
    for ``"full"``."""
    if part == "scan":
        return torch.cumsum(w.reshape(-1).double(), 0).float()
    if part == "lanes":
        x = w.reshape(-1, lanes).double()
        return (torch.cumsum(x, 1).float() / x.sum().float()).reshape(-1)
    if part == "roll":
        return torch.roll(w.reshape(-1), 1)
    if part == "ge_sum":
        pre = torch.cumsum(parts.double(), 0)
        j = _search_left(g.reshape(-1))
        before = torch.where((j > 0)[:, None], pre[torch.clamp(j - 1, min=0)],
                             torch.zeros_like(pre[:1]))
        return (pre[-1] - before).float()
    if part == "gather":
        return _ancestors(g.reshape(-1), parts)
    if part == "col":
        th = parts[:, 2]
        return torch.sin(th) + th * 0.5
    if part in ("front", "full"):
        x = w.reshape(-1)
        cs = torch.cumsum(x.double(), 0).float()
        z = x.double().sum().float()
        gg = x.shape[0] * (cs / z) - u0
        prop = _ancestors(gg, parts)
        if part == "front":
            return prop
        th = prop[:, 2]
        return prop, torch.sin(th) + th * 0.5
    raise ValueError(f"unknown part {part!r}; parts are {sorted(SCAN_PARTS)}")


# ---- the wrappers --------------------------------------------------------


class Probes:
    """The four probe kernels behind one object: each method launches its
    kernel on CUDA tensors (adding one to ``launch_count[name]``) and runs
    the plain version on CPU tensors."""

    def __init__(self):
        self.launch_count = dict(gather_rows=0, philox_normals=0, staged_writes=0,
                                 scan_resample=0)
        self._tickets: dict[torch.device, torch.Tensor] = {}  # staged_writes' grid ticket

    def gather_rows(self, hbm: torch.Tensor, y0: torch.Tensor) -> torch.Tensor:
        """``out[s] = hbm[y0[s]]``: hbm (rows, lanes) float32 with lanes a
        multiple of 4, y0 (S,) int32 in [0, rows)."""
        if hbm.device.type == "cpu":
            return gather_rows_reference(hbm, y0)
        _require(hbm, torch.float32, "hbm")
        _require(y0, torch.int32, "y0")
        if hbm.dim() != 2 or hbm.shape[1] % 4 or hbm.data_ptr() % 16:
            raise ValueError("hbm must be (rows, lanes) with lanes % 4 == 0 on a 16 B boundary")
        if y0.device != hbm.device or y0.dim() != 1:
            raise ValueError("y0 must be (S,) on hbm's device")
        built, lib = _lib()
        out = torch.empty((y0.shape[0], hbm.shape[1]), dtype=torch.float32, device=hbm.device)
        with torch.cuda.device(hbm.device):
            err = lib.mcl_probe_gather_rows(hbm.data_ptr(), hbm.shape[0], hbm.shape[1],
                                            y0.data_ptr(), y0.shape[0], out.data_ptr(),
                                            _stream(hbm.device))
        _check(built, err, "probe_gather_rows")
        self.launch_count["gather_rows"] += 1
        return out

    def philox_normals(self, seed: tuple[int, int], count: int, device, with_bits: bool = False):
        """``count`` N(0, 1) float32 draws of the Philox4x32-10 stream keyed
        by the two seed words; with ``with_bits`` also the (count / 2, 4)
        raw words (int64 on the CPU, uint32 bits in int32 on the card)."""
        device = torch.device(device)
        if device.type == "cpu":
            normals, words = philox_normals_reference(seed, count, device)
            return (normals, words) if with_bits else normals
        if count % 2:
            raise ValueError(f"count {count} must be even (normals come in pairs)")
        built, lib = _lib()
        out = torch.empty(count, dtype=torch.float32, device=device)
        bits = torch.empty((count // 2, 4), dtype=torch.int32, device=device) if with_bits else None
        with torch.cuda.device(device):
            err = lib.mcl_probe_philox_normals(seed[0] & 0xFFFFFFFF, seed[1] & 0xFFFFFFFF, count,
                                               out.data_ptr(),
                                               None if bits is None else bits.data_ptr(),
                                               _stream(device))
        _check(built, err, "probe_philox_normals")
        self.launch_count["philox_normals"] += 1
        return (out, bits) if with_bits else out

    def staged_writes(self, steps: int, per_step: int, a: float, b: float, c: float,
                      add: float, device) -> torch.Tensor:
        """Blocks 0..steps-1 each write ``a*i + b*s + c`` for s < per_step
        into a staging buffer; the last block to finish reads it all back
        plus ``add``. Returns the flat (steps * per_step,) read-back."""
        device = torch.device(device)
        if device.type == "cpu":
            return staged_writes_reference(steps, per_step, a, b, c, add, device)
        built, lib = _lib()
        stage = torch.empty(steps * per_step, dtype=torch.float32, device=device)
        # zeroed once: the block that draws the last ticket resets it
        ticket = self._tickets.get(device)
        if ticket is None:
            ticket = self._tickets[device] = torch.zeros(1, dtype=torch.int32, device=device)
        out = torch.empty_like(stage)
        with torch.cuda.device(device):
            err = lib.mcl_probe_staged_writes(steps, per_step, a, b, c, add, stage.data_ptr(),
                                              ticket.data_ptr(), out.data_ptr(), _stream(device))
        _check(built, err, "probe_staged_writes")
        self.launch_count["staged_writes"] += 1
        return out

    def scan_resample(self, part: str, w=None, g=None, parts=None, u0: float = 0.0,
                      lanes: int = 128):
        """One part of the mega prologue (:data:`SCAN_PARTS`) over n <= 8192
        elements: ``w`` weights (n,) or (n / lanes, lanes), ``g`` a
        non-decreasing (n,) CDF image, ``parts`` (n, 3) particles, all
        float32. Returns out_a, or (out_a, out_b) for ``"full"``."""
        ref = next(t for t in (w, g, parts) if t is not None)
        if ref.device.type == "cpu":
            return scan_resample_reference(part, w, g, parts, u0, lanes)
        if part not in SCAN_PARTS:
            raise ValueError(f"unknown part {part!r}; parts are {sorted(SCAN_PARTS)}")
        dev = ref.device
        needs_w = part in ("scan", "lanes", "roll", "front", "full")
        needs_g = part in ("ge_sum", "gather")
        needs_parts = part in ("ge_sum", "gather", "col", "front", "full")
        n = w.numel() if needs_w else (g if needs_g else parts).shape[0]
        for name, t, need, shape in (("w", w, needs_w, None), ("g", g, needs_g, (n,)),
                                     ("parts", parts, needs_parts, (n, 3))):
            if not need:
                continue
            if t is None:
                raise ValueError(f"part {part!r} needs {name}")
            _require(t, torch.float32, name)
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, not {dev}")
            if shape is not None and tuple(t.shape) != shape:
                raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if not 0 < n <= MAX_SCAN or (part == "lanes" and n % lanes):
            raise ValueError(f"n = {n} elements; the kernel takes 1..{MAX_SCAN} (whole rows)")
        built, lib = _lib()
        wide = part in ("ge_sum", "gather", "front", "full")
        out_a = torch.empty((n, 3) if wide else (n,), dtype=torch.float32, device=dev)
        out_b = torch.empty(n, dtype=torch.float32, device=dev) if part == "full" else None

        def ptr(t):
            return None if t is None else t.data_ptr()

        with torch.cuda.device(dev):
            err = lib.mcl_probe_scan_resample(
                SCAN_PARTS[part], ptr(w) if needs_w else None, ptr(g) if needs_g else None,
                ptr(parts) if needs_parts else None, n, lanes, u0, out_a.data_ptr(),
                ptr(out_b), _stream(dev))
        _check(built, err, "probe_scan_resample")
        self.launch_count["scan_resample"] += 1
        return (out_a, out_b) if part == "full" else out_a

    def curand_philox_words(self, seed: tuple[int, int], calls: int, device) -> torch.Tensor:
        """The CUDA toolkit's own Philox4_32_10 (``curand4`` from one state
        seeded ``seed[0] | seed[1] << 32``): (calls, 4) words, the oracle
        the hand-written generator is checked against. Not a probe kernel,
        so not counted."""
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError("the curand oracle runs on the card only")
        built, lib = _lib()
        words = torch.empty((calls, 4), dtype=torch.int32, device=device)
        with torch.cuda.device(device):
            err = lib.mcl_probe_curand_philox(seed[0] & 0xFFFFFFFF, seed[1] & 0xFFFFFFFF, calls,
                                              words.data_ptr(), _stream(device))
        _check(built, err, "curand oracle")
        return words
