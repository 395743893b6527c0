"""PCC / PDC FEC chains as precomputed per-config plans with jit-able bodies.

Mirrors the behavior of reference lib/src/phy/fec/{pcc_enc,pdc_enc,fec}.cpp:
- PCC: PLCF (40/80 bit) + CRC16 masked by closed-loop/beamforming flags
  (0x0000/0x5555/0xAAAA/0xFFFF), turbo, rate match to 196 bits, scramble with
  g_init 0x44454354. RX blind-decodes both PLCF types.
- PDC: TB + CRC24A, codeblock segmentation (C2 small blocks FIRST, matching
  pdc_enc.cpp:164-169), per-CB CRC24B when C>1, turbo, per-CB rate matching
  with rv support, network-id scrambling.

All LUTs (interleavers, rate-match gathers, CRC GF(2) matrices, scrambling
sequences) are numpy constants baked into the jitted function; device work is
gathers, XORs, mod-2 matmuls and the batched turbo codec.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ...sections.part3.cbsegm import CbSegm, cbsegm
from ...sections.part3.scrambling import PCC_G_INIT, lte_pr_sequence, pdc_g_init
from .crc import POLY_CRC16, POLY_CRC24A, POLY_CRC24B, crc_matrix
from .rate_match import cb_e_sizes, sel_indices
from .turbo_jax import turbo_decode, turbo_decode_early, turbo_encode

PLCF_MASKS = {(False, False): 0x0000, (True, False): 0x5555,
              (False, True): 0xAAAA, (True, True): 0xFFFF}


def _mask_bits(mask: int) -> np.ndarray:
    return np.array([(mask >> (15 - i)) & 1 for i in range(16)], dtype=np.uint8)


def _crc_device(bits: jax.Array, M: np.ndarray) -> jax.Array:
    """GF(2) CRC via matmul: bits [B, K] -> crc [B, L]."""
    m = jnp.asarray(M, dtype=jnp.float32)
    r = jnp.dot(bits.astype(jnp.float32), m, preferred_element_type=jnp.float32)
    return jnp.mod(r, 2.0).astype(jnp.uint8)


# ---------------------------------------------------------------------- PCC

@dataclass(frozen=True)
class PccPlan:
    plcf_type: int          # 1 or 2
    n_plcf_bits: int        # 40 or 80
    K: int                  # turbo block size (56 or 96)

    @staticmethod
    @lru_cache(maxsize=None)
    def get(plcf_type: int) -> "PccPlan":
        n = 40 if plcf_type == 1 else 80
        return PccPlan(plcf_type=plcf_type, n_plcf_bits=n, K=n + 16)


@lru_cache(maxsize=4)
def _pcc_luts(plcf_type: int):
    plan = PccPlan.get(plcf_type)
    sel = sel_indices(plan.K, 196, 0)
    scr = lte_pr_sequence(196, PCC_G_INIT)
    m_crc = crc_matrix(plan.n_plcf_bits, POLY_CRC16)
    return plan, sel, scr, m_crc


@partial(jax.jit, static_argnames=("plcf_type",))
def pcc_encode(a: jax.Array, cl: jax.Array, bf: jax.Array, plcf_type: int) -> jax.Array:
    """PLCF bits [B, 40/80] + flags [B] -> 196 coded bits [B, 196]."""
    plan, sel, scr, m_crc = _pcc_luts(plcf_type)
    crc = _crc_device(a, m_crc)
    # CRC mask from flags: bit pattern cl*0x5555 ^ bf*0xAAAA
    idx = jnp.arange(16)
    m_cl = ((0x5555 >> (15 - idx)) & 1).astype(jnp.uint8)
    m_bf = ((0xAAAA >> (15 - idx)) & 1).astype(jnp.uint8)
    mask = (cl[:, None].astype(jnp.uint8) * m_cl[None, :]) ^ (
        bf[:, None].astype(jnp.uint8) * m_bf[None, :])
    c = jnp.concatenate([a.astype(jnp.uint8), crc ^ mask], axis=1)
    d = turbo_encode(c, plan.K)                      # [B, 3, K+4]
    e = d.reshape(d.shape[0], -1)[:, jnp.asarray(sel)]
    return e ^ jnp.asarray(scr)[None, :]


@partial(jax.jit, static_argnames=("plcf_type", "n_iter"))
def pcc_decode(e_llr: jax.Array, plcf_type: int, n_iter: int = 8):
    """196 LLRs [B, 196] -> (plcf bits [B, n], crc_ok [B], cl [B], bf [B]).

    crc_ok is True only when the CRC syndrome matches one of the 4 valid masks.
    """
    plan, sel, scr, m_crc = _pcc_luts(plcf_type)
    llr = e_llr * (1.0 - 2.0 * jnp.asarray(scr, dtype=e_llr.dtype))[None, :]
    d = jnp.zeros((e_llr.shape[0], 3 * (plan.K + 4)), dtype=e_llr.dtype)
    d = d.at[:, jnp.asarray(sel)].add(llr)
    bits, _ = turbo_decode(d.reshape(-1, 3, plan.K + 4), plan.K, n_iter)
    a, crc_rx = bits[:, :plan.n_plcf_bits], bits[:, plan.n_plcf_bits:]
    syndrome = _crc_device(a, m_crc) ^ crc_rx        # [B, 16]
    pow2 = jnp.asarray(2 ** (15 - np.arange(16)), dtype=jnp.int32)
    s16 = jnp.sum(syndrome.astype(jnp.int32) * pow2[None, :], axis=1)
    ok = (s16 == 0x0000) | (s16 == 0x5555) | (s16 == 0xAAAA) | (s16 == 0xFFFF)
    cl = (s16 == 0x5555) | (s16 == 0xFFFF)
    bf = (s16 == 0xAAAA) | (s16 == 0xFFFF)
    return a, ok, cl, bf


# ---------------------------------------------------------------------- PDC

@dataclass(frozen=True)
class PdcPlan:
    """Static FEC geometry for one packet configuration."""
    N_TB_bits: int
    G: int
    Qm: int                 # N_bps
    Z: int
    seg: CbSegm
    cb_K: tuple[int, ...]       # per-cb K, processing order (C2 first)
    cb_E: tuple[int, ...]       # per-cb rate-matched size
    cb_rlen: tuple[int, ...]    # per-cb payload bits taken from the TB stream

    @staticmethod
    @lru_cache(maxsize=None)
    def get(N_TB_bits: int, G: int, Qm: int, Z: int) -> "PdcPlan":
        seg = cbsegm(N_TB_bits, Z)
        assert seg.F == 0, "filler bits unsupported (rejected by packet_sizes)"
        cb_K = seg.cb_sizes
        cb_E = tuple(cb_e_sizes(G, Qm, seg.C))
        cb_rlen = tuple(k - 24 if seg.C > 1 else k for k in cb_K)
        return PdcPlan(N_TB_bits=N_TB_bits, G=G, Qm=Qm, Z=Z, seg=seg,
                       cb_K=cb_K, cb_E=cb_E, cb_rlen=cb_rlen)


@lru_cache(maxsize=None)
def _pdc_luts(plan: PdcPlan, network_id: int, plcf_type: int, rv: int):
    scr = lte_pr_sequence(plan.G, pdc_g_init(network_id, plcf_type))
    sels = tuple(sel_indices(K, E, rv) for K, E in zip(plan.cb_K, plan.cb_E))
    m_tb = crc_matrix(plan.N_TB_bits, POLY_CRC24A)
    m_cb = {K: crc_matrix(K - 24, POLY_CRC24B) for K in set(plan.cb_K)} \
        if plan.seg.C > 1 else {}
    return scr, sels, m_tb, m_cb


@lru_cache(maxsize=None)
def _pdc_global_inv(plan: PdcPlan, network_id: int, plcf_type: int, rv: int):
    """Static INVERSE of _pdc_global_sel: per padded-d position, the
    e-indices that de-rate-match into it.

    Turns the RX-side scatter-add (arbitrary-index scatter, which XLA
    lowers far slower than gathers over the same static map) into
    `m_max` fused gathers: inv[m, j] = m-th e-index feeding d position j,
    padded with the sentinel G (a zero LLR slot appended by the caller).
    m_max = 1 whenever E <= 3 Kp per codeblock (pure puncturing, the
    common case); repetition (rate > matched) yields m_max 2+ and the
    gathers soft-combine exactly like the scatter-add did.
    """
    gsel, Kp = _pdc_global_sel(plan, network_id, plcf_type, rv)
    Dtot = len(plan.cb_K) * 3 * Kp
    G = gsel.size
    buckets: dict[int, list[int]] = {}
    for e, j in enumerate(gsel):
        buckets.setdefault(int(j), []).append(e)
    m_max = max(len(b) for b in buckets.values())
    inv = np.full((m_max, Dtot), G, np.int32)
    for j, bk in buckets.items():
        for m, e in enumerate(bk):
            inv[m, j] = e
    return inv, Kp


@lru_cache(maxsize=None)
def _pdc_global_sel(plan: PdcPlan, network_id: int, plcf_type: int, rv: int):
    """ONE flat [G] index map over the padded per-cb d-domain.

    The d-domain of codeblock i is [3, K_i + 4]; padding every cb to
    Kp = max(K)+4 gives a single [C, 3, Kp] tensor, and each cb's rate-match
    selection (stream s = sel // (K_i+4), pos p = sel % (K_i+4)) re-linearizes
    to i*3*Kp + s*Kp + p. Replaces C separate gathers/scatter-adds (32 at
    the u=8 b=16 flagship) with one fused gather (TX) / one segment-sum
    scatter (RX).
    """
    Kp = max(plan.cb_K) + 4
    out = []
    for i, (K, sel) in enumerate(zip(plan.cb_K, _pdc_luts(
            plan, network_id, plcf_type, rv)[1])):
        s, p = sel // (K + 4), sel % (K + 4)
        out.append(i * 3 * Kp + s * Kp + p)
    return np.concatenate(out).astype(np.int32), Kp


def _segment(b_seq: jax.Array, plan: PdcPlan, m_cb) -> list[jax.Array]:
    """TB+CRC24A bit stream [B, Bp] -> per-cb blocks [B, K_i] incl. CB CRCs."""
    blocks = []
    rp = 0
    for K, rlen in zip(plan.cb_K, plan.cb_rlen):
        payload = b_seq[:, rp:rp + rlen]
        rp += rlen
        if plan.seg.C > 1:
            cbcrc = _crc_device(payload, m_cb[K])
            payload = jnp.concatenate([payload, cbcrc], axis=1)
        blocks.append(payload)
    return blocks


def pdc_encode(tb_bits: jax.Array, plan: PdcPlan, network_id: int,
               plcf_type: int, rv: int = 0) -> jax.Array:
    """TB bits [B, N_TB_bits] -> G coded+scrambled bits [B, G]. jit-safe body."""
    scr, sels, m_tb, m_cb = _pdc_luts(plan, network_id, plcf_type, rv)
    crc_tb = _crc_device(tb_bits, m_tb)
    b_seq = jnp.concatenate([tb_bits.astype(jnp.uint8), crc_tb], axis=1)
    blocks = _segment(b_seq, plan, m_cb)

    # group identical K for one batched turbo call
    by_k: dict[int, list[int]] = {}
    for i, K in enumerate(plan.cb_K):
        by_k.setdefault(K, []).append(i)
    encoded: dict[int, jax.Array] = {}
    for K, idxs in by_k.items():
        stacked = jnp.concatenate([blocks[i] for i in idxs], axis=0)
        encoded[K] = turbo_encode(stacked, K)

    # assemble the padded per-cb d-domain [B, C, 3, Kp] and rate-match with
    # ONE fused gather over the flat global index map
    gsel, Kp = _pdc_global_sel(plan, network_id, plcf_type, rv)
    B = tb_bits.shape[0]
    C = len(plan.cb_K)
    D = jnp.zeros((B, C, 3, Kp), jnp.uint8)
    ptr = {K: 0 for K in by_k}
    for i, K in enumerate(plan.cb_K):
        j = ptr[K]
        ptr[K] += 1
        d = encoded[K][j * B:(j + 1) * B]                 # [B, 3, K+4]
        D = D.at[:, i, :, : K + 4].set(d)
    e = D.reshape(B, -1)[:, jnp.asarray(gsel)]
    return e ^ jnp.asarray(scr)[None, :]


def _cb_groups(plan: PdcPlan) -> dict[int, list[int]]:
    """Codeblock indices grouped by K (batched turbo decode groups)."""
    by_k: dict[int, list[int]] = {}
    for i, K in enumerate(plan.cb_K):
        by_k.setdefault(K, []).append(i)
    return by_k


def pdc_dematch(e_llr: jax.Array, plan: PdcPlan, network_id: int,
                plcf_type: int, rv: int = 0) -> dict[int, jax.Array]:
    """G LLRs [B, G] -> d-domain soft bits {K: [nK*B, 3, K+4]}.

    The d-domain tensors are the HARQ softbuffers (reference srsRAN
    softbuffer semantics, phy/harq/buffer_rx.hpp): retransmissions with any
    rv de-rate-match into the same d positions, so chase/IR combining is an
    elementwise add of these dicts.
    """
    scr, sels, m_tb, m_cb = _pdc_luts(plan, network_id, plcf_type, rv)
    llr = e_llr * (1.0 - 2.0 * jnp.asarray(scr, dtype=e_llr.dtype))[None, :]
    B = e_llr.shape[0]
    # de-rate-match as STATIC inverse gathers (m_max of them; soft combining
    # of repeated positions = their sum), then slice per-K groups (gathers
    # over a static map instead of an arbitrary-index scatter-add).
    inv, Kp = _pdc_global_inv(plan, network_id, plcf_type, rv)
    C = len(plan.cb_K)
    llr_pad = jnp.concatenate(
        [llr, jnp.zeros((B, 1), llr.dtype)], axis=1)
    # measured (u8b16 B=128): lane-axis gather, major-axis gather and the
    # original scatter-add all land at ~8 ms — the cost is the element
    # count + the per-K regrouping transposes, not the access pattern;
    # the gather form is kept for its explicit HARQ-combining semantics
    D = sum(llr_pad[:, jnp.asarray(inv[m])] for m in range(inv.shape[0]))
    D = D.reshape(B, C, 3, Kp)
    d_by_k: dict[int, jax.Array] = {}
    for K, idxs in _cb_groups(plan).items():
        blk = D[:, jnp.asarray(np.asarray(idxs, np.int32)), :, : K + 4]
        # cb-major row order (each cb's B rows contiguous), matching the
        # encoder grouping
        d_by_k[K] = jnp.moveaxis(blk, 1, 0).reshape(-1, 3, K + 4)
    return d_by_k


def pdc_decode_d(d_by_k: dict[int, jax.Array], plan: PdcPlan,
                 n_iter: int = 8, early_stop: bool = True):
    """Decode from (possibly HARQ-combined) d-domain softbuffers.

    early_stop mirrors the reference's CRC-gated iteration loop
    (pdc_enc.cpp:367-401): each codeblock carries a CRC (CRC24B per
    codeblock for C>1, the TB CRC24A itself for C==1), so decoding runs a
    `while_loop` that exits as soon as every codeblock's CRC passes —
    1-2 iterations at operating SNR instead of the full n_iter.
    """
    m_tb = crc_matrix(plan.N_TB_bits, POLY_CRC24A)
    m_cb = {K: crc_matrix(K - 24, POLY_CRC24B) for K in set(plan.cb_K)} \
        if plan.seg.C > 1 else {}
    by_k = _cb_groups(plan)
    B = d_by_k[plan.cb_K[0]].shape[0] // len(by_k[plan.cb_K[0]])
    d_by_cb: dict[int, jax.Array] = {}
    for K in by_k:
        if early_stop:
            m_k = m_cb[K] if plan.seg.C > 1 else crc_matrix(K - 24, POLY_CRC24A)
            # n_iter_min=2 matches the reference's SRSRAN_PDSCH_MIN_TDEC_ITERS
            # (pdc_enc.cpp:393): never accept a CRC pass from iteration 1.
            bits, _, _, _ = turbo_decode_early(d_by_k[K], jnp.asarray(m_k), K,
                                               n_iter_max=n_iter, n_iter_min=2)
        else:
            bits, _ = turbo_decode(d_by_k[K], K, n_iter)
        d_by_cb[K] = bits

    ptr = {K: 0 for K in by_k}
    payloads = []
    cb_ok = jnp.ones((B,), dtype=bool)
    for i, K in enumerate(plan.cb_K):
        j = ptr[K]
        ptr[K] += 1
        bits = d_by_cb[K][j * B:(j + 1) * B]
        if plan.seg.C > 1:
            payload, cbcrc = bits[:, :K - 24], bits[:, K - 24:]
            ok = jnp.all(_crc_device(payload, m_cb[K]) == cbcrc, axis=1)
            cb_ok = cb_ok & ok
        else:
            payload = bits
        payloads.append(payload)
    b_seq = jnp.concatenate(payloads, axis=1)
    tb, crc_rx = b_seq[:, :plan.N_TB_bits], b_seq[:, plan.N_TB_bits:]
    tb_ok = jnp.all(_crc_device(tb, m_tb) == crc_rx, axis=1) & cb_ok
    return tb, tb_ok


def pdc_decode(e_llr: jax.Array, plan: PdcPlan, network_id: int,
               plcf_type: int, rv: int = 0, n_iter: int = 8):
    """G LLRs [B, G] -> (tb bits [B, N_TB_bits], tb_crc_ok [B]). jit-safe body."""
    return pdc_decode_d(
        pdc_dematch(e_llr, plan, network_id, plcf_type, rv), plan, n_iter)
