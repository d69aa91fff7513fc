"""Public wrappers around the hand-written kernels — the port of
``repro.kernels.ops``.

Two families of entry points, with the JAX package's shapes:

* ``*_folded`` — the per-call route: logical-shape int8 in/out. Each call
  pads K and N to the kernel's quantum and slices the result back (the
  kernel masks ragged rows, so M is not padded);
  ``qmatmul_folded(paged=True)`` runs the paged kernel (Sec. 4.3) instead.
* ``*_planned`` — the graph-planned route (``preprocess.plan_layout``):
  weights and folded constants arrive pre-padded (and, inside an engine,
  already on the device), the activation arrives lane-padded (padded here
  only at graph entry), and the output stays padded with its padding lanes
  zeroed by the kernel.

Both families give SAME borders the input zero point: the per-call conv
wrapper and the planned conv's plain route pre-pad them; the fused conv
kernel (a planned multi-tap conv on the card) and the depthwise kernel fill
them themselves. Besides them:
``paged_fc`` (the engine's paged route on logical shapes), ``fmatmul`` (the
float FullyConnected product) and ``can_launch_kernels`` (the probe that
builds and launches a trivial kernel once and says why the kernel route is
unavailable). On CPU tensors the kernels' plain versions run; on CUDA
tensors the kernels.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.core.ops_ref import (FoldedConsts, MXU_LANES, clamp_bounds,
                                      pad_input_q, round_up, same_pads)
from . import _build
from . import paged_matmul as _pm
from . import qconv as _qc
from . import qdwconv as _dw
from . import qmatmul as _qm

QUANTUM = _qm.QUANTUM
LANE = MXU_LANES

#: Launches of the probe kernel so far in this process (at most one per
#: cache fill of :func:`can_launch_kernels`).
probe_launches = 0


@functools.cache
def can_launch_kernels():
    """Probe, once per process (cached), whether the kernel route can run
    here: build ``csrc/probe.cu`` with nvcc, launch it on an (8, 128)
    float32 block of zeros and check that it returns ones. Returns
    ``(True, None)``, or ``(False, "<reason>")`` without raising (no card,
    no nvcc, a refused launch, a wrong result). The twin of the reference's
    ``can_lower_noninterpret``; ``can_launch_kernels.cache_clear()`` probes
    again."""
    global probe_launches
    try:
        if not torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available() is False")
        fn = _build.function("probe", "repro_probe",
                             [ctypes.c_void_p] * 2
                             + [ctypes.c_int, ctypes.c_void_p])
        x = torch.zeros((8, LANE), dtype=torch.float32, device="cuda")
        out = torch.empty_like(x)
        _build.launch_check("probe", fn(_build.ptr(x, 4), _build.ptr(out, 4),
                                        x.numel(), _build.cuda_stream(x)))
        probe_launches += 1
        if not bool((out == 1).all()):  # synchronizes: faults surface here
            raise RuntimeError("probe kernel returned a wrong result")
        return True, None
    except Exception as e:  # no card / no nvcc / refused launch / ...
        msg = f"{type(e).__name__}: {e}"
        return False, " ".join(msg.split())[:200]


def _pad2(a, m0: int, m1: int):
    """Zero-pad a 2-D tensor's dimensions up to multiples of m0 and m1."""
    p0 = round_up(a.shape[0], m0) - a.shape[0]
    p1 = round_up(a.shape[1], m1) - a.shape[1]
    return F.pad(a, (0, p1, 0, p0)) if (p0 or p1) else a


def _pad_channel_consts(fc: FoldedConsts, n: int, n_pad: int, device):
    def grow(v, dtype):
        out = torch.zeros(n_pad, dtype=dtype, device=device)
        out[:n] = torch.as_tensor(v, dtype=dtype, device=device).reshape(-1)
        return out
    return (grow(fc.bias_term, torch.float32), grow(fc.rescale, torch.float32),
            grow(fc.w_sum_zx, torch.int32), grow(fc.const_off, torch.int32),
            grow(fc.z_w, torch.int32))


def _planned_consts(lay, device):
    return tuple(torch.as_tensor(c, device=device) for c in lay.consts)


def _lane_pad(x, lanes: int):
    """Zero-pad the trailing (lane) dimension to the planned physical width.
    A no-op when the producer already emitted padded layout."""
    if x.shape[-1] != lanes:
        x = F.pad(x, (0, lanes - x.shape[-1]))
    return x


def _n_true(lay):
    np_lanes = lay.out_shape[-1]
    return lay.n_true if np_lanes != lay.n_true else None


# ---------------------------------------------------------------------------
# FULLY_CONNECTED
# ---------------------------------------------------------------------------

def qmatmul_folded(x_q, w_q, fc: FoldedConsts, fused: str = "NONE", *,
                   paged: bool = False, page: int = LANE):
    """Folded Eq. (3) on the qmatmul kernel, logical shapes in and out. Any
    leading x rank: (..., K) @ (K, N) runs as one 2-D product. ``paged``
    runs the paged kernel instead, with M, K, N padded to 128 as the
    reference pads them, so ``page`` must divide the padded N."""
    lead = tuple(x_q.shape[:-1])
    x_q = x_q.reshape(-1, x_q.shape[-1])
    m = x_q.shape[0]
    n = w_q.shape[1]
    lo, hi = clamp_bounds(fc, fused)
    if paged:
        xp = _pad2(x_q, LANE, LANE).contiguous()
        wp = _pad2(w_q, LANE, LANE).contiguous()
        consts = _pad_channel_consts(fc, n, wp.shape[1], x_q.device)
        out = _pm.paged_qmatmul(xp, wp, *consts, page=page, lo=lo, hi=hi)
    else:
        xp = _pad2(x_q, 1, QUANTUM).contiguous()
        w_nk = _pad2(w_q.t(), QUANTUM, QUANTUM).contiguous()
        consts = _pad_channel_consts(fc, n, w_nk.shape[0], x_q.device)
        out = _qm.qmatmul(xp, w_nk, *consts, lo=lo, hi=hi)
    return out[:m, :n].reshape(lead + (n,))


def _channel(v, n: int, dtype, device):
    """A folded constant as a contiguous (n,) tensor: a no-op for one that
    is already per channel on the device."""
    t = torch.as_tensor(v, dtype=dtype, device=device).reshape(-1)
    return t if t.numel() == n else t.expand(n).contiguous()


def paged_fc(x_q, w_q, fc: FoldedConsts, n_pages: int, lo: float, hi: float):
    """The compiled engine's paged FullyConnected on the paged kernel:
    logical (..., K) x (K, N) int8 as they are, no padding, ``page`` =
    N // n_pages. ``lo``/``hi`` are the float32 bounds of the plain paged
    route (``ops_ref.fused_bounds_f32``), so both routes clamp alike."""
    lead = tuple(x_q.shape[:-1])
    n = w_q.shape[1]
    dev = x_q.device
    consts = tuple(_channel(v, n, dt, dev) for v, dt in (
        (fc.bias_term, torch.float32), (fc.rescale, torch.float32),
        (fc.w_sum_zx, torch.int32), (fc.const_off, torch.int32),
        (fc.z_w, torch.int32)))
    out = _pm.paged_qmatmul(x_q.reshape(-1, x_q.shape[-1]).contiguous(),
                            w_q.contiguous(), *consts, page=n // n_pages,
                            lo=lo, hi=hi)
    return out.reshape(lead + (n,))


def fmatmul(x, w):
    """Float matmul on the fmatmul kernel (the float FullyConnected path).
    The kernel masks ragged edges, so only K and N are zero-padded, to
    whole 16-byte rows (nothing for the speech model's 4000 x 4 FC), and the
    result is sliced back. Any leading x rank: (..., K) @ (K, N) runs as one
    2-D product."""
    lead = tuple(x.shape[:-1])
    x = x.reshape(-1, x.shape[-1])
    n = w.shape[1]
    per_chunk = 16 // x.element_size()
    out = _qm.fmatmul(_pad2(x, 1, per_chunk).contiguous(),
                      _pad2(w, per_chunk, per_chunk).contiguous())
    return out[:, :n].reshape(lead + (n,))


def qmatmul_planned(x_q, lay):
    """Planned-layout FC: x arrives logical (graph entry) or already in the
    (M', K') padded layout; the output (M', N') stays padded, its padding
    lanes zeroed by the kernel."""
    mp = lay.out_shape[0]
    if tuple(x_q.shape) != (mp, lay.in_lanes):
        x_q = F.pad(x_q, (0, lay.in_lanes - x_q.shape[1], 0, mp - x_q.shape[0]))
    return _qm.qmatmul(x_q.contiguous(),
                       torch.as_tensor(lay.w_nk, device=x_q.device),
                       *_planned_consts(lay, x_q.device), lo=lay.lo,
                       hi=lay.hi, n_true=_n_true(lay))


def qmatmul_planned_batched(x_q, lay):
    """Planned-layout FC with one leading batch dimension: ``x_q`` is
    (B, m, K) logical or (B, m, K') lane-padded; the batch merges into the
    kernel's rows (any count: the kernel masks the last row tile). Output
    (B, m, N') with padding lanes zeroed."""
    b, m = x_q.shape[0], x_q.shape[1]
    x2 = _lane_pad(x_q.reshape(b * m, x_q.shape[-1]), lay.in_lanes)
    out = _qm.qmatmul(x2.contiguous(),
                      torch.as_tensor(lay.w_nk, device=x_q.device),
                      *_planned_consts(lay, x_q.device), lo=lay.lo, hi=lay.hi,
                      n_true=_n_true(lay))
    return out.reshape(b, m, lay.out_shape[-1])


# ---------------------------------------------------------------------------
# CONV_2D — Eq. (7): im2col on the qmatmul kernel, or its fused conv variant
# ---------------------------------------------------------------------------

def qconv_folded(x_q, f_q, fc: FoldedConsts, *, stride, padding,
                 fused: str = "NONE"):
    """Folded Eq. (7) on im2col + qmatmul, logical NHWC in/out; SAME
    borders pre-padded with z_X."""
    stride = tuple(stride)
    kh, kw, cin, cout = f_q.shape
    lo, hi = clamp_bounds(fc, fused)
    x_q = pad_input_q(x_q, kh, kw, stride, padding, fc.z_x)
    w_nk = _pad2(f_q.reshape(kh * kw * cin, cout).t(), QUANTUM,
                 QUANTUM).contiguous()
    consts = _pad_channel_consts(fc, cout, w_nk.shape[0], x_q.device)
    out = _qc.qconv2d(x_q, w_nk, *consts, kh=kh, kw=kw, stride=stride,
                      lo=lo, hi=hi)
    return out[..., :cout]


def _pad_border_planned(x_q, kh, kw, stride, padding, z_x: int, c_true: int):
    """SAME→VALID pre-pad in padded-lane layout: border entries carry the
    input zero point on the ``c_true`` real lanes (so (X - z_X) vanishes and
    the folded ΣW term stays exact) but ZERO on the padding lanes (so they
    add nothing to the im2col rows' ΣX)."""
    if padding == "VALID":
        return x_q
    _, h, w, _ = x_q.shape
    (pt, pb), (pl, pr) = same_pads(h, w, kh, kw, stride)
    if not (pt or pb or pl or pr):
        return x_q
    xp = F.pad(x_q, (0, 0, pl, pr, pt, pb))
    if z_x == 0 or c_true == 0:
        return xp
    # fresh tensor: fill its border in place, real lanes only
    xp[:, :pt, :, :c_true] = z_x
    xp[:, pt + h:, :, :c_true] = z_x
    xp[:, :, :pl, :c_true] = z_x
    xp[:, :, pl + w:, :c_true] = z_x
    return xp


def conv_runs_fused(taps: int, device) -> bool:
    """Whether a planned Conv2D of ``taps`` = kh*kw filter taps runs on
    ``device`` as the fused conv kernel (``qmatmul.qconv_fused``): a
    multi-tap conv on a CUDA device does; a 1x1 conv (a reshape onto
    ``qmatmul``) and any conv on the CPU (im2col + the plain ``qmatmul``)
    do not. :func:`qconv_planned` dispatches by it, and
    ``analysis.budget`` derives the card's pad calls from it."""
    return taps > 1 and torch.device(device).type == "cuda"


def qconv_planned(x_q, lay, *, kh, kw, stride, padding):
    """Planned-layout Conv2D: lane-padded NHWC in (padded here only at graph
    entry), lane-padded NHWC out with padding lanes zeroed. By the filter:
    a multi-tap conv on a CUDA tensor is one launch of the fused conv
    kernel (SAME border, taps and packed K inside: no pad, no im2col copy);
    a 1x1/s1 conv is a reshape onto ``qmatmul``; a CPU tensor takes the
    plain version of im2col + ``qmatmul``."""
    stride = tuple(stride)
    x_q = _lane_pad(x_q, lay.in_lanes)
    if conv_runs_fused(kh * kw, x_q.device):
        return _qm.qconv_fused(
            x_q.contiguous(), torch.as_tensor(lay.w_packed, device=x_q.device),
            *_planned_consts(lay, x_q.device), kh=kh, kw=kw, stride=stride,
            pads=_border(x_q, kh, kw, stride, padding), c_true=lay.c_true,
            z_x=int(lay.z_x), lo=lay.lo, hi=lay.hi, n_true=_n_true(lay))
    x_q = _pad_border_planned(x_q, kh, kw, stride, padding, lay.z_x,
                              lay.c_true)
    return _qc.qconv2d(x_q, torch.as_tensor(lay.w_nk, device=x_q.device),
                       *_planned_consts(lay, x_q.device), kh=kh, kw=kw,
                       stride=stride, lo=lay.lo, hi=lay.hi,
                       n_true=_n_true(lay))


# ---------------------------------------------------------------------------
# DEPTHWISE_CONV_2D
# ---------------------------------------------------------------------------

def _border(x_q, kh, kw, stride, padding):
    """The (top, bottom, left, right) border of a SAME conv over NHWC
    ``x_q`` (all zero for VALID): the depthwise kernel fills it itself."""
    if padding == "VALID":
        return (0, 0, 0, 0)
    (pt, pb), (pl, pr) = same_pads(x_q.shape[1], x_q.shape[2], kh, kw, stride)
    return pt, pb, pl, pr


def qdwconv_folded(x_q, w_q, fc: FoldedConsts, *, stride, padding,
                   fused: str = "NONE"):
    """Folded Eq. (9) on the depthwise kernel, logical NHWC in/out; channels
    zero-padded to a multiple of 8, the reference's smallest channel block
    (the kernel then stages 8-byte pieces), the SAME border filled with z_X
    inside the kernel."""
    stride = tuple(stride)
    kh, kw, c, mult = w_q.shape
    if mult != 1:
        raise ValueError("depth multiplier 1 only")
    lo, hi = clamp_bounds(fc, fused)
    c_pad = round_up(c, 8)
    pads = _border(x_q, kh, kw, stride, padding)
    x_q = _lane_pad(x_q, c_pad).contiguous()
    w3 = _lane_pad(w_q[..., 0], c_pad).contiguous()
    consts = _pad_channel_consts(fc, c, c_pad, x_q.device)
    out = _dw.qdwconv(x_q, w3, *consts, stride=stride, pads=pads,
                      z_x=int(fc.z_x), lo=lo, hi=hi)
    return out[..., :c]


def qdwconv_planned(x_q, lay, *, stride, padding):
    """Planned-layout DepthwiseConv2D: lane-padded NHWC in/out. The kernel
    fills the SAME border with z_X on every lane (depthwise math never
    mixes lanes; the padding lanes' outputs are zeroed by ``c_true``), so
    no pad runs before it."""
    stride = tuple(stride)
    kh, kw, _ = lay.w_phys.shape
    x_q = _lane_pad(x_q, lay.in_lanes)
    return _dw.qdwconv(x_q.contiguous(),
                       torch.as_tensor(lay.w_phys, device=x_q.device),
                       *_planned_consts(lay, x_q.device), stride=stride,
                       pads=_border(x_q, kh, kw, stride, padding),
                       z_x=int(lay.z_x), lo=lay.lo, hi=lay.hi,
                       c_true=_n_true(lay))
