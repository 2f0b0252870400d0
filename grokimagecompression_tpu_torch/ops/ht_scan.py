"""HT stream coders (MEL / VLC / MagSgn): the plain torch versions.

Port of `grokimagecompression_tpu/ops/ht_scan_pallas.py`. One code-block
is one lane; each lane walks its own (T,) op stream with a bit-serial
coder state and emits 32-bit little-endian words (at most one per step),
a valid mask, and its final state. Contract of each scan:

- `mel_scan(valid, bit)`: (T, B) int32 with T % 4 == 0, four events per
  step -> words (T/4, B) int32, mask (T/4, B) bool, state (7, B) int32
  (tmp, nbits, cap, run, k, wacc, wcnt).
- `vlc_scan(vals, lens)`: (T, B) int32 appends of <= 16 bits -> words
  (T, B), mask, state (5, B) (tmp, used, lg8f, wacc, wcnt).
- `ms_scan(vals, lens)`: (T, B) int32 appends of <= 16 bits -> words
  (T, B), mask, state (5, B) (q, qbits, maxb, wacc, wcnt).

These scans are part of the plain version of the HT encoder
(`ops/ht_enc.encode_segments_plain`). On the card the encoder is one
kernel, `csrc/ht_enc.cu`, which builds the streams and codes them in
shared memory, so no op stream reaches a scan there: a scan wrapper
given a CUDA tensor raises. On a CPU tensor it runs the plain version,
a Python loop over the step bodies below, which run in int64 so the
uint32 word accumulator never overflows.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .ht_tables import MEL_EXP

MEL_INIT = (0, 0, 8, 0, 0, 0, 0)
VLC_INIT = (0xF, 4, 1, 0, 0)
MS_INIT = (0, 0, 8, 0, 0)

ScanOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# Step bodies (int64 lane vectors)
# ---------------------------------------------------------------------------


def word_push(wacc, wcnt, byte, emit):
    """Push `byte` into the little-endian word accumulator where `emit`;
    returns (wacc', wcnt', word_out, word_full)."""
    wacc = wacc | torch.where(emit, byte << (8 * wcnt), 0)
    wcnt = wcnt + emit.to(wcnt.dtype)
    full = wcnt >= 4
    word = torch.where(full, wacc, 0)
    wacc = torch.where(full, 0, wacc)
    wcnt = torch.where(full, 0, wcnt)
    return wacc, wcnt, word, full


def mel_step(carry, val, b, mel_exp):
    """One MEL event (bit-accumulator part). carry: (tmp, nbits, cap, run,
    k); `mel_exp` is MEL_EXP as a tensor. Returns (carry', byte, full)."""
    tmp, nbits, cap, run, k = carry
    e = mel_exp[k]
    run0 = run + 1
    hit = run0 >= (1 << e)
    bit1 = b == 1
    val1 = val == 1
    ecnt = torch.where(bit1, 1 + e, hit.to(e.dtype))
    ebits = torch.where(bit1, run & ((1 << e) - 1), 1)
    ecnt = torch.where(val1, ecnt, 0)
    ebits = ebits & ((1 << ecnt) - 1)
    new_run = torch.where(val1, torch.where(bit1 | hit, 0, run0), run)
    new_k = torch.where(
        val1,
        torch.where(bit1, torch.clamp(k - 1, min=0),
                    torch.where(hit, torch.clamp(k + 1, max=12), k)),
        k)
    combined = (tmp << ecnt) | ebits
    nb = nbits + ecnt
    full = nb >= cap
    rem = torch.clamp(nb - cap, min=0)
    out_byte = torch.where(full, combined >> rem, 0)
    new_tmp = torch.where(full, combined & ((1 << rem) - 1), combined)
    new_cap = torch.where(full, torch.where(out_byte == 0xFF, 7, 8), cap)
    return (new_tmp, torch.where(full, rem, nb), new_cap, new_run,
            new_k), out_byte, full


def mel_super_step(carry, vals4, bits4, mel_exp):
    """Four MEL events -> <= 4 bytes -> <= 1 word. carry: (tmp, nbits, cap,
    run, k, wacc, wcnt)."""
    core, (wacc, wcnt) = carry[:5], carry[5:]
    word_o = full_o = None
    for j in range(4):
        core, byte, full = mel_step(core, vals4[j], bits4[j], mel_exp)
        wacc, wcnt, w, wf = word_push(wacc, wcnt, byte, full)
        word_o = w if word_o is None else word_o | w
        full_o = wf if full_o is None else full_o | wf
    return core + (wacc, wcnt), word_o, full_o


def vlc_step(carry, q, qbits):
    """One VLC append (<= 16 bits) -> <= 3 bytes -> <= 1 word. carry: (tmp,
    used, lg8f, wacc, wcnt)."""
    tmp, used, lg8f, wacc, wcnt = carry
    word_o = full_o = None
    for _ in range(7):
        active = qbits > 0
        t = torch.clamp(torch.minimum(8 - lg8f - used, qbits), 0, 8)
        t = torch.where(active, t, 0)
        tmp = tmp | ((q & ((1 << t) - 1)) << used)
        used = used + t
        q = torch.where(active, q >> t, q)
        qbits = qbits - t
        boundary = active & (used == 8 - lg8f)
        retry = boundary & (lg8f == 1) & (tmp != 0x7F)
        emit = boundary & ~retry
        wacc, wcnt, w, wf = word_push(wacc, wcnt, torch.where(emit, tmp, 0),
                                      emit)
        word_o = w if word_o is None else word_o | w
        full_o = wf if full_o is None else full_o | wf
        lg8f = torch.where(retry, 0,
                           torch.where(emit, (tmp > 0x8F).to(tmp.dtype),
                                       lg8f))
        tmp = torch.where(emit, 0, tmp)
        used = torch.where(emit, 0, used)
    return (tmp, used, lg8f, wacc, wcnt), word_o, full_o


def ms_step(carry, v, ln):
    """One MagSgn append (<= 16 bits) -> <= 3 bytes -> <= 1 word. carry:
    (q, qbits, maxb, wacc, wcnt). q keeps the int32 wrap of the reference."""
    q, qbits, maxb, wacc, wcnt = carry
    q = _wrap_i32(q | (v << qbits))
    qbits = qbits + ln
    word_o = full_o = None
    for _ in range(3):
        emit = qbits >= maxb
        byte = torch.where(emit, q & ((1 << maxb) - 1), 0)
        q = torch.where(emit, q >> maxb, q)
        qbits = torch.where(emit, qbits - maxb, qbits)
        maxb = torch.where(emit & (byte == 0xFF), 7,
                           torch.where(emit, 8, maxb))
        wacc, wcnt, w, wf = word_push(wacc, wcnt, byte, emit)
        word_o = w if word_o is None else word_o | w
        full_o = wf if full_o is None else full_o | wf
    return (q, qbits, maxb, wacc, wcnt), word_o, full_o


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int64 value of its low 32 bits read as int32."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= (1 << 31), x - (1 << 32), x)


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    return _wrap_i32(x).to(torch.int32)


# ---------------------------------------------------------------------------
# Plain versions (the scans of the HT encoder's plain version)
# ---------------------------------------------------------------------------


def _init(values, B, device):
    return tuple(torch.full((B,), v, dtype=torch.int64, device=device)
                 for v in values)


def _run_plain(step, init, a, b, rows) -> ScanOut:
    B = a.shape[-1]
    carry = _init(init, B, a.device)
    words = torch.zeros((rows, B), dtype=torch.int64, device=a.device)
    mask = torch.zeros((rows, B), dtype=torch.bool, device=a.device)
    for t in range(rows):
        carry, w, f = step(carry, a[t], b[t])
        words[t] = w
        mask[t] = f
    return _to_i32(words), mask, _to_i32(torch.stack(carry))


def mel_scan_plain(valid: torch.Tensor, bit: torch.Tensor) -> ScanOut:
    T, B = valid.shape
    mel_exp = torch.as_tensor(MEL_EXP, dtype=torch.int64,
                              device=valid.device)
    v4 = valid.to(torch.int64).reshape(T // 4, 4, B)
    b4 = bit.to(torch.int64).reshape(T // 4, 4, B)
    return _run_plain(
        lambda c, v, b: mel_super_step(c, v, b, mel_exp),
        MEL_INIT, v4, b4, T // 4)


def vlc_scan_plain(vals: torch.Tensor, lens: torch.Tensor) -> ScanOut:
    return _run_plain(vlc_step, VLC_INIT, vals.to(torch.int64),
                      lens.to(torch.int64), vals.shape[0])


def ms_scan_plain(vals: torch.Tensor, lens: torch.Tensor) -> ScanOut:
    return _run_plain(ms_step, MS_INIT, vals.to(torch.int64),
                      lens.to(torch.int64), vals.shape[0])


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(a: torch.Tensor, b: torch.Tensor, t_multiple: int = 1) -> None:
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(f"expected two (T, B) tensors of one shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"expected int32, got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"inputs on {a.device} and {b.device}")
    if a.device.type != "cpu":
        raise ValueError(f"the scans run on CPU tensors only, got "
                         f"{a.device}: on the card the HT encoder is "
                         f"ops/ht_enc.encode_segments")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    if a.shape[0] % t_multiple:
        raise ValueError(f"T={a.shape[0]} is not a multiple of {t_multiple}")


def mel_scan(valid: torch.Tensor, bit: torch.Tensor) -> ScanOut:
    """MEL coder, four events per step (see module docstring)."""
    _check(valid, bit, 4)
    return mel_scan_plain(valid, bit)


def vlc_scan(vals: torch.Tensor, lens: torch.Tensor) -> ScanOut:
    """VLC bit packer with the 0x8F/0x7F stuffing rule."""
    _check(vals, lens)
    return vlc_scan_plain(vals, lens)


def ms_scan(vals: torch.Tensor, lens: torch.Tensor) -> ScanOut:
    """MagSgn bit packer with 0xFF stuffing."""
    _check(vals, lens)
    return ms_scan_plain(vals, lens)
