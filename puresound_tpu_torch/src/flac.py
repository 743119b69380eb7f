"""Minimal pure-Python FLAC decoder (read-only; a copy of
puresound_tpu/src/flac.py).

`AudioIO` decodes FLAC through it where the C++ library of `csrc/` does
not load, without soundfile / ffmpeg / torchaudio. Supports the standard
subset produced by the `flac` encoder:
8/16/24-bit, mono/stereo, constant/verbatim/fixed/LPC subframes, all stereo
decorrelation modes. Spec: https://xiph.org/flac/format.html
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


class _BitReader:
    __slots__ = ("data", "pos", "bitpos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.bitpos = 0

    def read_uint(self, nbits: int) -> int:
        val = 0
        while nbits > 0:
            byte = self.data[self.pos]
            avail = 8 - self.bitpos
            take = min(avail, nbits)
            shift = avail - take
            bits = (byte >> shift) & ((1 << take) - 1)
            val = (val << take) | bits
            self.bitpos += take
            if self.bitpos == 8:
                self.bitpos = 0
                self.pos += 1
            nbits -= take
        return val

    def read_sint(self, nbits: int) -> int:
        val = self.read_uint(nbits)
        if val >= (1 << (nbits - 1)):
            val -= 1 << nbits
        return val

    def read_unary(self) -> int:
        count = 0
        while self.read_uint(1) == 0:
            count += 1
        return count

    def read_rice(self, param: int) -> int:
        q = self.read_unary()
        r = self.read_uint(param) if param > 0 else 0
        val = (q << param) | r
        return (val >> 1) ^ -(val & 1)  # zigzag

    def align(self):
        if self.bitpos:
            self.bitpos = 0
            self.pos += 1

    def read_utf8_number(self) -> int:
        first = self.read_uint(8)
        if first < 0x80:
            return first
        n = 0
        mask = 0x80
        while first & mask:
            n += 1
            mask >>= 1
        val = first & (mask - 1)
        for _ in range(n - 1):
            val = (val << 6) | (self.read_uint(8) & 0x3F)
        return val


def _decode_residual(br: _BitReader, n_samples: int, predictor_order: int):
    method = br.read_uint(2)
    if method > 1:
        raise ValueError("reserved residual coding method")
    param_bits = 4 if method == 0 else 5
    escape = (1 << param_bits) - 1
    partition_order = br.read_uint(4)
    n_partitions = 1 << partition_order
    residual = np.empty(n_samples - predictor_order, np.int64)
    idx = 0
    for p in range(n_partitions):
        count = n_samples >> partition_order
        if p == 0:
            count -= predictor_order
        param = br.read_uint(param_bits)
        if param == escape:
            nbits = br.read_uint(5)
            for i in range(count):
                residual[idx + i] = br.read_sint(nbits) if nbits else 0
        else:
            for i in range(count):
                residual[idx + i] = br.read_rice(param)
        idx += count
    return residual


_FIXED_COEFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _decode_subframe(br: _BitReader, n_samples: int, bps: int) -> np.ndarray:
    if br.read_uint(1) != 0:
        raise ValueError("invalid subframe sync")
    sf_type = br.read_uint(6)
    wasted = 0
    if br.read_uint(1):
        wasted = 1 + br.read_unary()
        bps -= wasted

    if sf_type == 0:  # CONSTANT
        out = np.full(n_samples, br.read_sint(bps), np.int64)
    elif sf_type == 1:  # VERBATIM
        out = np.array([br.read_sint(bps) for _ in range(n_samples)], np.int64)
    elif 8 <= sf_type <= 12:  # FIXED
        order = sf_type - 8
        warm = [br.read_sint(bps) for _ in range(order)]
        resid = _decode_residual(br, n_samples, order)
        out = np.empty(n_samples, np.int64)
        out[:order] = warm
        coefs = _FIXED_COEFS[order]
        for i in range(order, n_samples):
            pred = 0
            for j, c in enumerate(coefs):
                pred += c * out[i - 1 - j]
            out[i] = pred + resid[i - order]
    elif sf_type >= 32:  # LPC
        order = sf_type - 31
        warm = [br.read_sint(bps) for _ in range(order)]
        precision = br.read_uint(4) + 1
        shift = br.read_sint(5)
        coefs = [br.read_sint(precision) for _ in range(order)]
        resid = _decode_residual(br, n_samples, order)
        out = np.empty(n_samples, np.int64)
        out[:order] = warm
        ca = np.array(coefs, np.int64)
        for i in range(order, n_samples):
            pred = int(np.dot(ca, out[i - order : i][::-1])) >> shift
            out[i] = pred + resid[i - order]
    else:
        raise ValueError(f"reserved subframe type {sf_type}")

    if wasted:
        out <<= wasted
    return out


_BLOCKSIZE_TABLE = [0, 192, 576, 1152, 2304, 4608, -1, -2,
                    256, 512, 1024, 2048, 4096, 8192, 16384, 32768]
_RATE_TABLE = [0, 88200, 176400, 192000, 8000, 16000, 22050, 24000,
               32000, 44100, 48000, 96000, -1, -2, -3, -4]


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file -> (float32 array [channels, samples] in [-1, 1],
    sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC file")
    pos = 4
    sr = channels = bps = total = None
    # metadata blocks
    while True:
        header = data[pos]
        last = header & 0x80
        btype = header & 0x7F
        length = int.from_bytes(data[pos + 1 : pos + 4], "big")
        body = data[pos + 4 : pos + 4 + length]
        if btype == 0:  # STREAMINFO
            sr = (int.from_bytes(body[10:13], "big") >> 4)
            channels = ((body[12] >> 1) & 0x07) + 1
            bps = (((body[12] & 1) << 4) | (body[13] >> 4)) + 1
            total = int.from_bytes(body[13:18], "big") & ((1 << 36) - 1)
        pos += 4 + length
        if last:
            break

    out = [np.empty(total, np.int64) for _ in range(channels)]
    written = 0
    while written < total:
        # frame header
        br = _BitReader(data, pos)
        sync = br.read_uint(14)
        if sync != 0x3FFE:
            raise ValueError(f"bad frame sync at {pos}")
        br.read_uint(1)  # reserved
        br.read_uint(1)  # blocking strategy
        bs_code = br.read_uint(4)
        sr_code = br.read_uint(4)
        ch_code = br.read_uint(4)
        bps_code = br.read_uint(3)
        br.read_uint(1)
        br.read_utf8_number()  # frame/sample number
        if bs_code == 6:
            block_size = br.read_uint(8) + 1
        elif bs_code == 7:
            block_size = br.read_uint(16) + 1
        else:
            block_size = _BLOCKSIZE_TABLE[bs_code]
        if sr_code == 12:
            br.read_uint(8)
        elif sr_code in (13, 14):
            br.read_uint(16)
        br.read_uint(8)  # header CRC

        if ch_code < 8:
            n_ch = ch_code + 1
            mode = "independent"
        else:
            n_ch = 2
            mode = {8: "left_side", 9: "right_side", 10: "mid_side"}[ch_code]

        subs = []
        for c in range(n_ch):
            ch_bps = bps
            if (mode == "left_side" and c == 1) or \
               (mode == "right_side" and c == 0) or \
               (mode == "mid_side" and c == 1):
                ch_bps += 1
            subs.append(_decode_subframe(br, block_size, ch_bps))
        br.align()
        br.read_uint(16)  # frame CRC
        pos = br.pos

        if mode == "independent":
            chans = subs
        elif mode == "left_side":
            left = subs[0]
            chans = [left, left - subs[1]]
        elif mode == "right_side":
            right = subs[1]
            chans = [subs[0] + right, right]
        else:  # mid_side
            mid, side = subs
            left = ((mid << 1) | (side & 1)) + side
            chans = [left >> 1, (left - (side << 1)) >> 1]
            chans = [((mid << 1 | (side & 1)) + side) >> 1,
                     ((mid << 1 | (side & 1)) - side) >> 1]

        n = min(block_size, total - written)
        for c in range(channels):
            out[c][written : written + n] = chans[c][:n]
        written += n

    scale = float(1 << (bps - 1))
    wav = np.stack(out).astype(np.float32) / scale
    return wav, sr
