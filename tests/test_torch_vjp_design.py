"""The designs of the ordered VJP kernels B10 and B14, written in PyTorch as
the kernels compute them, against the JAX package on the CPU.

B10 (csrc/vjp_kernel.cu): R = vjp_kernel.ordered_receivers(block) receivers
per thread of a block of ``block`` receivers, the fused per-pair formula
  pos_bar_k = 3 sum_j u (m_j dot_k - m_k dot_j) d + m_k sum_j w g_j
              - g_k sum_j m_j w,
each j tile of ``block`` sources summed into its own partials before they
are added to the totals, and the d2 == 0 select in every tile ('masked') or
only in the block's own tile ('fast'); held to JAX's vjp_pos_pallas
(interpret mode) at rtol 1e-3, atol 1e-4 of the scale, the fp32 VJPs' bound
(tests/test_torch_vjp.py).

B14 (csrc/vjp_mxu.cu): which lane of which warp computes which (row,
column) of each 16 x 16 step of its mma.sync m16n8k16 A fragments, one
16-row strip per warp (vjp_mxu.rect_threads(tile) threads) at tiles 64 and
128: every pair of a T x T tile exactly once. Then the sums assembled from those fragments (fp32 w and c
rounded to bf16, the bf16 [hi | lo] operands, each tile's products from a
fresh fp64 accumulator added into fp32 running sums, hi + lo folded)
against JAX's vjp_rect_mxu (interpret mode) at rtol 2e-2, atol 5e-3 of the
scale, the bf16-accumulate bound (tests/test_slot_pipe.py:24).

The card tests (tests/test_torch_gpu.py) hold the kernels' threads per CTA,
from their occupancy queries, to the same two helpers, so these models
cannot outlive the kernels' designs.

Inputs are np.float32 arrays: tests/conftest.py turns on jax_enable_x64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_nbody_tpu.ops import vjp_kernel as jv
from mini_nbody_tpu.ops import vjp_mxu as jm
from mini_nbody_tpu_torch.ops import vjp_kernel as vk
from mini_nbody_tpu_torch.ops import vjp_mxu as vm

torch.set_num_threads(1)

FP32 = (1e-3, 1e-4)
BF16 = (2e-2, 5e-3)
FAR = 1.0e18


def _inputs(n, masses, softening, seed):
    rng = np.random.default_rng(seed + n)
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    if softening < 1e-6:
        pos[200] = pos[3]  # two distinct bodies at one point
    g = rng.normal(size=(n, 3)).astype(np.float32)
    m = rng.uniform(0.5, 2.0, n).astype(np.float32) if masses else None
    return pos, g, m


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all()
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1] * scale)


# ----------------------------------------------------------------- B10 ---

def b10_receivers(block):
    """Receiver offsets within a block, per thread: thread i owns i +
    (block / R) q, q < R."""
    r = vk.ordered_receivers(block)
    threads = block // r
    return [[i + threads * q for q in range(r)] for i in range(threads)]


def b10_model(pos, g, m, softening, block, mode):
    """B10's sums as the kernel forms them: each block's receivers by
    thread and micro-tile slot, each j tile's partials added to the totals
    in tile order, the fused formula, the 3 and m_k applied at the end."""
    n = pos.shape[0]
    mass = torch.ones(n) if m is None else m
    out = torch.empty((n, 3))
    for k0 in range(0, n, block):
        idx = torch.tensor([k0 + o for row in b10_receivers(block)
                            for o in row])
        idx = idx[idx < n]  # receivers past n compute and are not written
        pk, gk, mk = pos[idx], g[idx], mass[idx]
        t = torch.zeros((len(idx), 3))
        s = torch.zeros((len(idx), 3))
        sw = torch.zeros(len(idx))
        for base in range(0, n, block):
            j = slice(base, min(base + block, n))  # pads add exact zeros
            d = pos[None, j] - pk[:, None]
            d2 = (d * d).sum(-1)
            inv = torch.rsqrt(d2 + softening)
            w = inv * inv * inv
            u = w * inv * inv
            if mode == "masked" or base == k0:
                w = torch.where(d2 == 0, torch.zeros_like(w), w)
                u = torch.where(d2 == 0, torch.zeros_like(u), u)
            dot_k = (gk[:, None] * d).sum(-1)
            dot_j = (g[None, j] * d).sum(-1)
            coeff = u * (mass[None, j] * dot_k - mk[:, None] * dot_j)
            t += (coeff[..., None] * d).sum(1)
            s += (w[..., None] * g[None, j]).sum(1)
            sw += (mass[None, j] * w).sum(1)
        out[idx] = (3.0 * t - gk * sw[:, None]) + mk[:, None] * s
    return out


@pytest.mark.parametrize("block,r", [(32, 1), (64, 2), (96, 1), (128, 4),
                                     (256, 4), (512, 4), (1024, 4)])
def test_b10_micro_tiles_cover_each_receiver_once(block, r):
    assert vk.ordered_receivers(block) == r
    seen = sorted(o for row in b10_receivers(block) for o in row)
    assert seen == list(range(block))
    assert block // r % 32 == 0  # whole warps


@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("softening,mode", [(1e-2, "fast"), (1e-2, "masked"),
                                            (1e-9, "masked")])
@pytest.mark.parametrize("block,r", [(64, 2), (128, 4)])
def test_b10_fused_formula_vs_jax(masses, softening, mode, block, r):
    # 300 bodies: a ragged last block and j tile; at softening 1e-9 bodies 3
    # and 200 coincide ('fast' promises there are none).
    pos, g, m = _inputs(300, masses, softening, seed=40)
    want = jv.vjp_pos_pallas(jnp.asarray(pos), jnp.asarray(g),
                             None if m is None else jnp.asarray(m),
                             softening, tile_i=64, tile_j=128, interpret=True,
                             coincident=mode)
    assert vk.ordered_receivers(block) == r
    got = b10_model(torch.from_numpy(pos), torch.from_numpy(g),
                    None if m is None else torch.from_numpy(m), softening,
                    block, mode)
    _close(got, want, FP32)


# ----------------------------------------------------------------- B14 ---

def b14_fragments(tile):
    """For every (warp, step s, lane, A register a, half e) of a CTA, the
    (row, column) of the tile whose (w, c) that lane computes: rows r0 =
    16 warp + g and r0 + 8, columns c0 = 16 s + 2 t, c0 + 1, c0 + 8, c0 + 9
    (g = lane / 4, t = lane % 4); A registers 0-3 hold (r0, c0..c0+1),
    (r0 + 8, c0..c0+1), (r0, c0+8..c0+9), (r0 + 8, c0+8..c0+9)."""
    out = []
    for warp in range(vm.rect_threads(tile) // 32):
        r0 = 16 * warp
        for s in range(tile // 16):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                for a in range(4):
                    for e in range(2):
                        row = r0 + g + 8 * (a % 2)
                        col = 16 * s + 2 * t + 8 * (a // 2) + e
                        out.append((warp, s, lane, a, e, row, col))
    return out


@pytest.mark.parametrize("tile", [64, 128])
def test_b14_fragments_cover_every_pair_once(tile):
    count = np.zeros((tile, tile), dtype=int)
    for *_, row, col in b14_fragments(tile):
        count[row, col] += 1
    assert (count == 1).all()


def _split_bf16(v):
    """[hi | lo] of v in bf16 (hi = bf16(v), lo = bf16(v - hi)), as fp64."""
    hi = v.to(torch.bfloat16).float()
    return torch.cat([hi, (v - hi).to(torch.bfloat16).float()], -1).double()


def b14_model(pk, gk, pj, gj, softening, tile):
    """B14's raw rows (nk, 8): per k tile and j tile, each strip's A
    fragments assembled from the lanes that own them (b14_fragments), times
    the bf16 operands per 16-column step into a fresh fp64 accumulator per
    j tile, added into fp32 running sums; then hi + lo folded. pk, pj: (n,
    4) positions with mass (1 for unit masses)."""
    nk, nj = pk.shape[0], pj.shape[0]
    frag = torch.tensor(b14_fragments(tile))
    rows_f, cols_f = frag[:, 5], frag[:, 6]
    pad = -nj % tile
    pj = torch.cat([pj, torch.tensor([[FAR, FAR, FAR, 0.0]]).repeat(pad, 1)])
    gj = torch.cat([gj, torch.zeros((pad, 3))])
    qg = _split_bf16(torch.cat([gj, pj[:, 3:]], 1))
    qp = _split_bf16(torch.cat([pj[:, :3], torch.ones((pj.shape[0], 1))], 1))
    qp[nj:] = 0.0  # pads: zero operands
    qg[nj:] = 0.0
    out = torch.empty((nk, 8))
    for k0 in range(0, nk, tile):
        kr = slice(k0, min(k0 + tile, nk))
        sums = torch.zeros((tile, 16))
        pkt = torch.cat([pk[kr], torch.tensor([[FAR, FAR, FAR, 0.0]]).repeat(
            tile - pk[kr].shape[0], 1)])
        gkt = torch.cat([gk[kr], torch.zeros((tile - gk[kr].shape[0], 3))])
        for j0 in range(0, pj.shape[0], tile):
            jr = slice(j0, j0 + tile)
            w, c, _, _ = vm._wc(pkt, pj[jr], gkt, gj[jr], softening, True)
            # Each lane's values, placed back into the warps' A blocks.
            a_w = torch.zeros((tile, tile), dtype=torch.float64)
            a_c = torch.zeros((tile, tile), dtype=torch.float64)
            a_w[rows_f, cols_f] = w[rows_f, cols_f].to(
                torch.bfloat16).double()
            a_c[rows_f, cols_f] = c[rows_f, cols_f].to(
                torch.bfloat16).double()
            part = torch.cat([a_w @ qg[jr], a_c @ qp[jr]], 1)
            sums = sums + part.float()
        rows = sums[:pk[kr].shape[0]]
        out[kr] = torch.cat([rows[:, 0:4] + rows[:, 4:8],
                             rows[:, 8:12] + rows[:, 12:16]], 1)
    return out


@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("softening", [1e-2, 1e-9])
@pytest.mark.parametrize("square", [True, False])
@pytest.mark.parametrize("tile", [64, 128])
def test_b14_fragment_sums_vs_jax(masses, softening, square, tile):
    pos, g, m = _inputs(300, masses, softening, seed=41)
    k = slice(0, 300) if square else slice(150, 250)  # holds body 200
    mk = None if m is None else m[k].copy()
    want = jm.vjp_rect_mxu(jnp.asarray(pos[k]), jnp.asarray(g[k]),
                           jnp.asarray(pos), jnp.asarray(g),
                           None if m is None else jnp.asarray(mk),
                           None if m is None else jnp.asarray(m),
                           softening=softening, tile=64, interpret=True)
    tp, tg = torch.from_numpy(pos), torch.from_numpy(g)
    mass = torch.ones(300) if m is None else torch.from_numpy(m)
    p4 = torch.cat([tp, mass[:, None]], 1)
    rows = b14_model(p4[k], tg[k], p4, tg, softening, tile)
    got = vm._combine(rows, mass[k], tg[k], tp[k])
    _close(got, want, BF16)
