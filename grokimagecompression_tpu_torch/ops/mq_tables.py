"""MQ coder tables and context layout, owned by the port.

Copies of `grokimagecompression_tpu/t1/mq.py` (Table C.2 as `MQ_TABLE`,
the 19-context layout `CTX_*`) and of the packed forms of
`grokimagecompression_tpu/ops/mq_jax.py` (`_TBL_PACKED`, `_CTX_INIT`,
`NCTX_WORDS`, `_CTX_INIT_PACKED`, and `NSTATE` / `STATE_INIT` as
`DENSE_NSTATE` / `DENSE_STATE_INIT`). `tests/test_torch_host_copies.py`
holds them equal to the originals.

The coder state of the port's MQ scan (`ops/mq_torch.py`,
`csrc/mq_scan.cu`) is the reference's without its word accumulator
(`wacc`, `wcnt`), since the port writes bytes straight to each lane's
segment.
"""

from __future__ import annotations

from typing import Tuple

# (Qe, NMPS, NLPS, SWITCH): Table C.2.
MQ_TABLE: Tuple[Tuple[int, int, int, int], ...] = (
    (0x5601, 1, 1, 1),
    (0x3401, 2, 6, 0),
    (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0),
    (0x0521, 5, 29, 0),
    (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1),
    (0x5401, 8, 14, 0),
    (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0),
    (0x3001, 11, 17, 0),
    (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0),
    (0x1601, 29, 21, 0),
    (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0),
    (0x5101, 17, 15, 0),
    (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0),
    (0x3401, 20, 18, 0),
    (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0),
    (0x2401, 23, 20, 0),
    (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0),
    (0x1801, 26, 23, 0),
    (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0),
    (0x1201, 29, 26, 0),
    (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0),
    (0x09C1, 32, 29, 0),
    (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0),
    (0x0441, 35, 32, 0),
    (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0),
    (0x0141, 38, 35, 0),
    (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0),
    (0x0049, 41, 38, 0),
    (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0),
    (0x0009, 44, 41, 0),
    (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0),
    (0x5601, 46, 46, 0),
)

NUM_CTXS = 19
CTX_ZC = 0    # 9 zero-coding contexts: 0..8
CTX_SC = 9    # 5 sign-coding contexts: 9..13
CTX_MAG = 14  # 3 magnitude-refinement contexts: 14..16
CTX_RL = 17   # run-length (aggregation) context
CTX_UNI = 18  # uniform context

# Packed table row: qe(16) << 13 | nmps(6) << 7 | nlps(6) << 1 | switch.
_TBL_PACKED = tuple(
    (qe << 13) | (nmps << 7) | (nlps << 1) | sw
    for (qe, nmps, nlps, sw) in MQ_TABLE)

# Initial context states (Annex D): (idx << 1) | mps.
_CTX_INIT = [0] * NUM_CTXS
_CTX_INIT[CTX_ZC] = 4 << 1
_CTX_INIT[CTX_RL] = 3 << 1
_CTX_INIT[CTX_UNI] = 46 << 1

# Context states packed 4 to an int32 word, 8 bits each: word k holds
# contexts 4k..4k+3.
NCTX_WORDS = 5
_CTX_INIT_PACKED = [
    sum(_CTX_INIT[4 * k + j] << (8 * j)
        for j in range(4) if 4 * k + j < NUM_CTXS)
    for k in range(NCTX_WORDS)]

# The port's coder state: A, C, CT, the delayed output byte (-1 = none
# yet) and the five packed context words.
NSTATE = 4 + NCTX_WORDS
STATE_INIT = [0x8000, 0, 12, -1] + _CTX_INIT_PACKED

# The reference's coder state (`mq_jax.NSTATE`, `STATE_INIT`): the port's
# with the word accumulator after the delayed byte, `wacc` (the bytes of
# the word being filled, little-endian) and `wcnt` (how many). Only the
# dense-output scan (`ops/mq_scan.run_mq_scans`) keeps it.
DENSE_NSTATE = 6 + NCTX_WORDS
DENSE_STATE_INIT = [0x8000, 0, 12, -1, 0, 0] + _CTX_INIT_PACKED
# The dense scan numbers a lane's words within chunks of this many steps
# (its `m8` output; the reference's scan kernel chunk `_CHUNK`).
DENSE_CHUNK = 256
