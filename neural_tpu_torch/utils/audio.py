"""WAV loading and resampling (reference: vendored dr_wav.h,
audio_run.cpp:73). The standard library's ``wave`` and numpy: PCM
8/16/24/32-bit WAVs, downmixed to mono, linearly resampled to 16 kHz.
"""
from __future__ import annotations

import wave
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """→ (float32 samples in [-1, 1] [n, channels], sample_rate)."""
    with wave.open(path, "rb") as w:
        n = w.getnframes()
        ch = w.getnchannels()
        sw = w.getsampwidth()
        sr = w.getframerate()
        raw = w.readframes(n)
    if sw == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128) / 128
    elif sw == 2:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768
    elif sw == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        v = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        v = np.where(v >= 1 << 23, v - (1 << 24), v)
        x = v.astype(np.float32) / (1 << 23)
    elif sw == 4:
        x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648
    else:
        raise ValueError(f"unsupported sample width {sw}")
    return x.reshape(-1, ch), sr


def load_audio_16k(path: str) -> np.ndarray:
    """WAV file → mono float32 at 16 kHz (Whisper's input)."""
    x, sr = read_wav(path)
    mono = x.mean(axis=1)
    if sr == 16000:
        return mono
    n_out = int(round(len(mono) * 16000 / sr))
    t_out = np.linspace(0, len(mono) - 1, n_out)
    return np.interp(t_out, np.arange(len(mono)), mono).astype(np.float32)
