"""VQ nearest-neighbour search: a hand-written CUDA kernel and its plain
PyTorch version.

Port of the JAX package's ``vq_nearest_pallas`` → ``_vq_kernel``
(``titok_tpu/ops/vq_distance.py``), which becomes ``csrc/vq_nearest.cu``.
For ``z [S, D]`` and a codebook ``c [N, D]`` (both f32) each returns

    indices[s] = argmin_n (|c_n|² − 2 z_s·c_n)     int32 [S]
    dists[s]   = that minimum (the partial distance) f32 [S]

``|z_s|²`` is constant per row and dropped; ties go to the lowest index.
All arithmetic is fp32 on both sides, never TF32 or bf16: a rounded product
flips near-ties, and token ids must be stable.

- :func:`vq_nearest` — the entry point the quantizer calls, through the
  custom op :func:`vq_nearest_op` (``ops/custom_ops.py``): the kernel for
  CUDA tensors (it raises rather than fall back), the plain version for CPU
  tensors.
- :func:`vq_nearest_reference` — the plain version: an explicit fp32 sum
  over D, one product and one add at a time in the order d = 0..D-1, chunk
  by chunk of rows, so it needs no matmul and reads no global TF32 flag.
- :func:`code_norms` — ``|c_n|²``, the plain version's (outside its dense
  block, as JAX computes it). The kernel computes its own, in shared
  memory.
- :func:`distances_at` — the plain version's distance of given (row, code)
  pairs, bit for bit as :func:`vq_nearest_reference` computes that entry.
- :func:`plan_for` — how the kernel splits the work of one call, a pure
  function of ``(S, N)``.

The kernel contracts the products into FMAs (``-2 z·c`` by one multiply
and D - 1 FMAs, then the norm added); the plain version rounds each
product first. So the two can pick different codes on a row whose two
best distances are a few ulp apart. ``tests/test_torch_kernels.py`` and
``chip_smoke.py`` hold the kernel to the plain version by
:func:`gate`, which says how.

``launches`` counts kernel launches; a run reads it to show that its path
went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

# kernel launches (one per vq_nearest call on CUDA tensors)
launches = {"f32": 0}
# elements of one dense f32 [rows, N] block in the plain version (128 MiB)
_DENSE_ELEMS = 2**25
# the kernel's fixed choices (csrc/vq_nearest.cu): rows per thread, lane
# groups a warp (each on its own codes), rows a CTA, codes a range steps
# through at a time (one argmin run), the largest D, warps a CTA and CTAs a
# cluster
ROWS_PER_THREAD = 4
GROUPS = 2
ROWS = ROWS_PER_THREAD * 32 // GROUPS
TILE = 32
MAX_DIM = 16
MAX_WARPS = 16
MAX_CLUSTER = 8
# the SMs of an H100 SXM
NUM_SMS = 132


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def code_norms(codebook: torch.Tensor) -> torch.Tensor:
    """``|c_n|²`` f32 ``[N]``, outside the kernel as the JAX package
    computes it; the kernel and the plain version read the same one."""
    cf = codebook.to(torch.float32)
    return (cf * cf).sum(1)


def _dots(z: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``z·c`` along the last dim, one product and one add at a time;
    ``z`` and ``c`` broadcast against each other."""
    acc = z[..., 0] * c[..., 0]
    for d in range(1, z.shape[-1]):
        acc = acc + z[..., d] * c[..., d]
    return acc


def vq_nearest_reference(z: torch.Tensor, codebook: torch.Tensor):
    """``(indices int32 [S], dists f32 [S])`` computed densely, a chunk of
    rows at a time; ``torch.min`` returns the first index of the minimum."""
    zf = z.to(torch.float32)
    cf = codebook.to(torch.float32)
    S, N = zf.shape[0], cf.shape[0]
    cn = code_norms(cf)
    idx = torch.empty((S,), dtype=torch.int32, device=zf.device)
    dist = torch.empty((S,), dtype=torch.float32, device=zf.device)
    chunk = max(1, _DENSE_ELEMS // max(N, 1))
    for a in range(0, S, chunk):
        b = min(a + chunk, S)
        d = cn[None, :] - 2.0 * _dots(zf[a:b, None, :], cf[None, :, :])
        m, i = torch.min(d, dim=1)
        idx[a:b] = i.to(torch.int32)
        dist[a:b] = m
    return idx, dist


def distances_at(z: torch.Tensor, codebook: torch.Tensor,
                 indices: torch.Tensor) -> torch.Tensor:
    """The plain version's partial distance of row s to code
    ``indices[s]``, f32 ``[S]``: the same operations in the same order as
    its dense entry, so the same bits."""
    zf = z.to(torch.float32)
    cf = codebook.to(torch.float32)
    ix = indices.long()
    return code_norms(cf)[ix] - 2.0 * _dots(zf, cf[ix])


def gate(z, codebook, indices, dists, eps: float = 1e-6, exact: bool = False) -> dict:
    """How far ``(indices, dists)`` (the kernel's) is from the plain
    version on ``z``/``codebook``. Per row s, with ``d*`` the plain
    minimum:

    - ``slack``: ``(plain distance of the chosen code − d*) / (1+|d*|)``;
    - ``dist_err``: ``|dists − d*| / (1+|d*|)``.

    ``ok`` when both are at most ``eps`` on every row (an FMA-contracted
    8-term dot product stays within a few ulp of the rounded one), every
    index lies in ``[0, N)`` and, with ``exact`` (for a codebook without
    near ties, or with duplicated rows, where the lower index must win),
    every index equals the plain version's. ``same`` is the share of rows
    whose index equals the plain version's, ``abs_err`` the largest
    ``|dists − d*|``."""
    ref_idx, ref_d = vq_nearest_reference(z, codebook)
    N = codebook.shape[0]
    in_range = bool(((indices >= 0) & (indices < N)).all())
    ix = indices.clamp(0, max(N - 1, 0))
    scale = 1.0 + ref_d.abs()
    slack = ((distances_at(z, codebook, ix) - ref_d) / scale).max().item()
    abs_err = (dists - ref_d).abs().max().item()
    dist_err = ((dists - ref_d).abs() / scale).max().item()
    same = (indices == ref_idx).to(torch.float32).mean().item()
    ok = in_range and slack <= eps and dist_err <= eps and (not exact or same == 1.0)
    return {"ok": ok, "slack": slack, "dist_err": dist_err, "abs_err": abs_err, "same": same,
            "in_range": in_range, "eps": eps}


@functools.cache
def _kernel():
    """The C entry point of ``csrc/vq_nearest.cu``, built at first use."""
    from titok_tpu_torch.ops import _build

    fn = _build.load("vq_nearest").vq_nearest
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class Plan(NamedTuple):
    """How one launch splits ``S`` rows by ``N`` codes. A CTA holds
    ``ROWS`` rows; its ``warps`` warps, and the ``GROUPS`` lane groups of
    each, share them. The codes are cut into ``ranges`` contiguous ranges
    of ``per_range`` codes, one for each (cluster rank, warp, group); a
    cluster of ``cluster`` CTAs covers all N codes of one row block."""

    warps: int
    cluster: int
    per_range: int
    row_blocks: int

    @property
    def ctas(self) -> int:
        return self.row_blocks * self.cluster

    @property
    def ranges(self) -> int:
        return self.cluster * self.warps * GROUPS


@functools.lru_cache(maxsize=256)
def plan_for(S: int, N: int, sms: int = NUM_SMS) -> Plan:
    """The kernel's split of ``S`` rows by ``N`` codes. One CTA of 16 warps
    fills an SM, so each row block gets the largest cluster, a power of two
    up to ``MAX_CLUSTER``, whose grid still fits the card one CTA an SM;
    fewer warps, and a smaller cluster, where a range would hold fewer than
    ``TILE`` codes. base_vq (S 4096, N 16384): 64 row blocks by clusters of
    2, 128 CTAs of 16 warps."""
    blocks = -(-max(S, 1) // ROWS)
    warps = max(1, min(MAX_WARPS, N // (GROUPS * TILE)))
    cluster = 1
    while (2 * cluster <= MAX_CLUSTER and 2 * cluster * blocks <= sms
           and 2 * cluster * warps * GROUPS * TILE <= N):
        cluster *= 2
    ranges = cluster * warps * GROUPS
    per_range = -(-(-(-N // ranges)) // 4) * 4
    return Plan(warps, cluster, per_range, blocks)


def _check(z: torch.Tensor, codebook: torch.Tensor) -> None:
    if z.dim() != 2 or codebook.dim() != 2 or z.shape[1] != codebook.shape[1]:
        raise ValueError(f"want z [S,D] and codebook [N,D]; got {tuple(z.shape)}, "
                         f"{tuple(codebook.shape)}")
    if not 1 <= z.shape[1] <= MAX_DIM:
        raise ValueError(f"the kernel takes 1 <= D <= {MAX_DIM}, got {z.shape[1]}")
    if codebook.shape[0] < 1:
        raise ValueError("the codebook is empty")
    for name, t in (("z", z), ("codebook", codebook)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32, got {t.dtype}")
        if t.device != z.device:
            raise ValueError(f"{name} is on {t.device}, z on {z.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(z: torch.Tensor, codebook: torch.Tensor):
    """The kernel on CUDA tensors: ``(indices, dists)``. Raises for any
    other device."""
    if z.device.type != "cuda":
        raise ValueError(f"no kernel for device {z.device}")
    _check(z, codebook)
    S, D = z.shape
    N = codebook.shape[0]
    idx = torch.empty((S,), dtype=torch.int32, device=z.device)
    dist = torch.empty((S,), dtype=torch.float32, device=z.device)
    if S == 0:
        return idx, dist
    p = plan_for(S, N)
    with torch.cuda.device(z.device):
        err = _kernel()(z.data_ptr(), codebook.data_ptr(), idx.data_ptr(), dist.data_ptr(),
                        S, N, D, p.warps, p.cluster, p.per_range,
                        torch.cuda.current_stream(z.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vq_nearest launch failed: CUDA error {err}")
    launches["f32"] += 1
    return idx, dist


@torch.library.custom_op("titok::vq_nearest", mutates_args=(), device_types="cpu")
def vq_nearest_op(z: torch.Tensor, codebook: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(indices, dists)`` as the custom op ``torch.ops.titok.vq_nearest``:
    the plain version for CPU tensors, the kernel (launch counted) for CUDA
    tensors, no implementation for any other device."""
    return vq_nearest_reference(z, codebook)


vq_nearest_op.register_kernel("cuda")(_launch)


@vq_nearest_op.register_fake
def _(z, codebook):
    S = z.shape[0]
    return z.new_empty((S,), dtype=torch.int32), z.new_empty((S,), dtype=torch.float32)


def vq_nearest(z: torch.Tensor, codebook: torch.Tensor, impl: str = "auto"):
    """``(indices int32 [S], dists f32 [S])``. ``impl``: 'auto' calls
    :func:`vq_nearest_op`, the kernel for CUDA tensors and the plain version
    for CPU tensors; 'reference' the plain version on any device."""
    if impl == "reference":
        return vq_nearest_reference(z, codebook)
    if impl != "auto":
        raise ValueError(f"unknown vq impl {impl!r}")
    return vq_nearest_op(z, codebook)
