"""Quantized DepthwiseConv2D — Eq. (9) on the card.

Port of ``repro.kernels.qdwconv.qdwconv``, with the SAME border fused in:
the kernel takes the unpadded activation and the pads, and reads the input
zero point wherever a tap falls outside it. The kernel is hand-written CUDA
C++ for sm_90a (``csrc/qdwconv.cu``; its header note gives the design);
:func:`dw_tile` picks its tile, and :func:`qdwconv` checks the operands,
allocates the output and launches it for CUDA tensors, and runs the plain
version (``ref.qdwconv_ref``) for CPU tensors. A CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ._build import check_operands, cuda_stream, ptr
from .ref import qdwconv_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: Launches of the CUDA kernel so far in this process; the wrapper adds one
#: per launch and nowhere else (the plain version on CPU tensors does not
#: count).
launches = 0

#: The tile rule's constants: channels a thread owns, the block count it
#: aims for (one per SM of an H100), the fewest channel bytes a block takes
#: where C allows (a whole 32-byte sector), the threads a block may have and
#: its shared memory (the default 48 KB). From a sweep of tiles on the H100
#: at the person detector's shapes.
V = 4
MIN_BLOCKS = 132
MIN_GROUP_BYTES = 32
MAX_THREADS = 256
SMEM_BYTES = 48 * 1024


@functools.cache
def _kernel():
    return _build.function("qdwconv", "repro_qdwconv",
                           [_P] * 8 + [_I] * 16 + [_F, _F, _I, _P])


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def dw_smem(cg: int, th: int, tpg: int, kh: int, kw: int, sh: int,
            sw: int) -> int:
    """Shared-memory bytes of one block of ``csrc/qdwconv.cu`` (its
    ``Layout``): the input band with its halo, the weights and the five
    constants of CG groups of 4 channels."""
    rows_in = (th - 1) * sh + kh
    cols_in = (tpg - 1) * sw + kw
    return (_round16(rows_in * cols_in * cg * V) + _round16(kh * kw * cg * V)
            + 5 * cg * V * 4)


def dw_tile(b: int, oh: int, ow: int, c: int, kh: int, kw: int, sh: int,
            sw: int) -> tuple:
    """(CG, TH, TPG): the tile of ``csrc/qdwconv.cu`` for a (B, OH, OW, C)
    output. A thread owns 4 channels of one pixel; a block owns CG such
    groups, a band of TH output rows and TPG columns of it. Start with every
    channel and the whole row (up to 64 threads a row, by halving the
    channel groups while they hold more than :data:`MIN_GROUP_BYTES`), as
    many rows as :data:`MAX_THREADS` threads hold; then, while there are
    fewer than :data:`MIN_BLOCKS` blocks, halve the band, then the channel
    groups (down to :data:`MIN_GROUP_BYTES`); finally thin the band, then
    the row, until the block fits :data:`SMEM_BYTES`."""
    cv = c // V
    tpg = min(ow, 64)
    cg = cv

    def can_halve():
        return cg % 2 == 0 and cg * V > MIN_GROUP_BYTES

    while can_halve() and cg * tpg > 64:
        cg //= 2
    while cg * tpg > MAX_THREADS and tpg > 1:
        tpg = -(-tpg // 2)
    th = max(1, min(oh, MAX_THREADS // (cg * tpg)))
    while th > 1 and dw_blocks(b, oh, ow, c, (cg, th, tpg)) < MIN_BLOCKS:
        th = -(-th // 2)
    while can_halve() and dw_blocks(b, oh, ow, c, (cg, th, tpg)) < MIN_BLOCKS:
        cg //= 2
    while dw_smem(cg, th, tpg, kh, kw, sh, sw) > SMEM_BYTES and th > 1:
        th = -(-th // 2)
    while dw_smem(cg, th, tpg, kh, kw, sh, sw) > SMEM_BYTES and tpg > 1:
        tpg = -(-tpg // 2)
    return cg, th, tpg


def dw_blocks(b: int, oh: int, ow: int, c: int, tile) -> int:
    """The grid size of a launch with ``tile`` = (CG, TH, TPG)."""
    cg, th, tpg = tile
    return b * -(-oh // th) * -(-ow // tpg) * (c // V // cg)


def qdwconv(x_q, w_q, bias_term, rescale, w_sum_zx, const_off, z_w, *,
            stride, pads=(0, 0, 0, 0), z_x=0, lo=float("-inf"),
            hi=float("inf"), c_true=None):
    """x_q (B, H, W, C) int8, w_q (kh, kw, C) int8, consts (C,) -> (B, OH,
    OW, C) int8 of the depthwise conv with the folded epilogue. ``pads`` =
    (top, bottom, left, right): the border, read as ``z_x`` on every lane
    (``ops_ref.same_pads`` gives SAME's; all zero is VALID on a pre-padded
    input). Each pad is smaller than the window, and a bottom or right pad
    must be read by the window walk. C must be a multiple of 4. ``c_true``:
    when set, output lanes >= c_true are written as zero (the padded-layout
    contract)."""
    global launches
    b, H, W, c = x_q.shape
    kh, kw = w_q.shape[:2]
    sh, sw = (int(s) for s in stride)
    pt, pb, pl, pr = (int(p) for p in pads)
    check_operands("qdwconv", dict(
        x_q=x_q, w_q=w_q, bias_term=bias_term, rescale=rescale,
        w_sum_zx=w_sum_zx, const_off=const_off, z_w=z_w), dict(
        x_q=(torch.int8, (b, H, W, c)), w_q=(torch.int8, (kh, kw, c)),
        bias_term=(torch.float32, (c,)), rescale=(torch.float32, (c,)),
        w_sum_zx=(torch.int32, (c,)), const_off=(torch.int32, (c,)),
        z_w=(torch.int32, (c,))))
    hp, wp = H + pt + pb, W + pl + pr
    if c % V or sh < 1 or sw < 1 or hp < kh or wp < kw or b * c * H * W == 0:
        raise ValueError(f"qdwconv: unsupported geometry x {tuple(x_q.shape)}, "
                         f"w {tuple(w_q.shape)}, stride {(sh, sw)}, pads "
                         f"{(pt, pb, pl, pr)}")
    oh = (hp - kh) // sh + 1
    ow = (wp - kw) // sw + 1
    if (min(pt, pb, pl, pr) < 0 or max(pt, pb) >= kh or max(pl, pr) >= kw
            or (pb and (oh - 1) * sh + kh != hp)
            or (pr and (ow - 1) * sw + kw != wp)):
        raise ValueError(f"qdwconv: pads {(pt, pb, pl, pr)} do not fit a "
                         f"{kh}x{kw}/{(sh, sw)} window walk over {H}x{W}")
    if not -128 <= int(z_x) <= 127:
        raise ValueError(f"qdwconv: z_x {z_x} is not an int8")
    if x_q.device.type == "cpu":
        return qdwconv_ref(x_q, w_q, bias_term, rescale, w_sum_zx, const_off,
                           z_w, stride=(sh, sw), pads=(pt, pb, pl, pr),
                           z_x=z_x, lo=lo, hi=hi, c_true=c_true)
    cg, th, tpg = dw_tile(b, oh, ow, c, kh, kw, sh, sw)
    out = torch.empty((b, oh, ow, c), dtype=torch.int8, device=x_q.device)
    err = _kernel()(
        ptr(x_q, 4), ptr(w_q, 4), ptr(bias_term, 16), ptr(rescale, 16),
        ptr(w_sum_zx, 16), ptr(const_off, 16), ptr(z_w, 16), ptr(out, 4),
        b, H, W, c, kh, kw, sh, sw, pt, pl, oh, ow, int(z_x), cg, th, tpg,
        float(lo), float(hi), c if c_true is None else int(c_true),
        cuda_stream(x_q))
    _build.launch_check("qdwconv", err)
    launches += 1
    return out
