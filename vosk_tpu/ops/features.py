"""Streaming MFCC / log-mel filterbank feature extraction.

Replaces the reference's Kaldi feature pipeline (`OnlineNnet2FeaturePipeline`,
used at reference src/recognizer.cc:28,308 and configured from ``mfcc.conf`` /
``fbank.conf`` at src/model.cc:218-228).

Design: everything is expressed as dense float32 matmuls, at full precision
(`HIGHEST`: no reduced-precision tensor-core passes, so the features keep
Kaldi parity on any backend) —
  frames [N, padded_len] @ DFT_real/imag [padded_len, n_bins] -> power spectrum
  power [N, n_bins]     @ mel filterbank [n_bins, n_mels]    -> mel energies
  log-mel [N, n_mels]   @ DCT/lifter     [n_mels, n_ceps]    -> MFCC
No FFT butterflies, no scalar loops, static shapes throughout.  Streaming is a
carried ring of raw samples + a total-sample counter; each fixed-size chunk
yields a fixed (masked) number of frames.

Frame/DSP semantics follow Kaldi so that Kaldi-trained models keep their WER:
povey window, pre-emphasis 0.97, DC removal, snip-edges framing, mel scale
1127*ln(1+f/700), type-II DCT with lifter 22 — parameterized by the same
option names that appear in model ``mfcc.conf`` files.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class FrameOptions:
    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    dither: float = 1.0
    preemphasis_coefficient: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"  # povey|hamming|hanning|rectangular|blackman
    blackman_coeff: float = 0.42
    round_to_power_of_two: bool = True
    snip_edges: bool = True

    @property
    def window_size(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_length_ms)

    @property
    def window_shift(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_shift_ms)

    @property
    def padded_window_size(self) -> int:
        n = self.window_size
        if self.round_to_power_of_two:
            p = 1
            while p < n:
                p *= 2
            return p
        return n


@dataclasses.dataclass
class MelOptions:
    num_bins: int = 23
    low_freq: float = 20.0
    high_freq: float = 0.0  # <=0: offset from Nyquist


@dataclasses.dataclass
class MfccOptions:
    frame_opts: FrameOptions = dataclasses.field(default_factory=FrameOptions)
    mel_opts: MelOptions = dataclasses.field(default_factory=MelOptions)
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    cepstral_lifter: float = 22.0


@dataclasses.dataclass
class FbankOptions:
    frame_opts: FrameOptions = dataclasses.field(default_factory=FrameOptions)
    mel_opts: MelOptions = dataclasses.field(
        default_factory=lambda: MelOptions(num_bins=23)
    )
    use_energy: bool = False
    use_log_fbank: bool = True
    use_power: bool = True


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def inverse_mel_scale(mel):
    return 700.0 * (np.exp(mel / 1127.0) - 1.0)


def feature_window(opts: FrameOptions) -> np.ndarray:
    n = opts.window_size
    a = 2.0 * math.pi / (n - 1)
    i = np.arange(n, dtype=np.float64)
    if opts.window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * i)
    elif opts.window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    elif opts.window_type == "povey":
        w = (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    elif opts.window_type == "rectangular":
        w = np.ones(n)
    elif opts.window_type == "blackman":
        bc = opts.blackman_coeff
        w = bc - 0.5 * np.cos(a * i) + (0.5 - bc) * np.cos(2 * a * i)
    else:
        raise ValueError(f"unknown window type {opts.window_type}")
    return w.astype(np.float32)


def mel_banks(mel_opts: MelOptions, frame_opts: FrameOptions) -> np.ndarray:
    """Triangular mel filterbank as a dense [n_fft_bins, num_bins] matrix."""
    nfft = frame_opts.padded_window_size
    nyquist = 0.5 * frame_opts.samp_freq
    low = mel_opts.low_freq
    high = mel_opts.high_freq if mel_opts.high_freq > 0 else nyquist + mel_opts.high_freq
    assert 0.0 <= low < nyquist and low < high <= nyquist, (low, high, nyquist)

    nbins = nfft // 2 + 1
    fft_freqs = np.arange(nbins) * (frame_opts.samp_freq / nfft)
    mel_low, mel_high = mel_scale(low), mel_scale(high)
    mel_delta = (mel_high - mel_low) / (mel_opts.num_bins + 1)
    mel_f = mel_scale(fft_freqs)

    mat = np.zeros((nbins, mel_opts.num_bins), dtype=np.float32)
    for j in range(mel_opts.num_bins):
        left = mel_low + j * mel_delta
        center = mel_low + (j + 1) * mel_delta
        right = mel_low + (j + 2) * mel_delta
        up = (mel_f - left) / (center - left)
        down = (right - mel_f) / (right - center)
        mat[:, j] = np.maximum(0.0, np.minimum(up, down))
    return mat


def dft_matrices(nfft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT matrices [nfft, nfft//2+1] (matmul-form rFFT)."""
    k = np.arange(nfft // 2 + 1)
    n = np.arange(nfft)
    ang = -2.0 * np.pi * np.outer(n, k) / nfft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def dct_matrix(num_rows: int, num_cols: int) -> np.ndarray:
    """Type-II DCT matrix (Kaldi normalization), shape [num_cols, num_rows]
    laid out for right-multiplication: mel [., M] @ dct -> ceps [., num_rows]."""
    m = np.arange(num_cols)
    mat = np.zeros((num_cols, num_rows), dtype=np.float64)
    mat[:, 0] = math.sqrt(1.0 / num_cols)
    for k in range(1, num_rows):
        mat[:, k] = math.sqrt(2.0 / num_cols) * np.cos(
            math.pi * k * (2 * m + 1) / (2 * num_cols)
        )
    return mat.astype(np.float32)


def lifter_coeffs(num_ceps: int, q: float) -> np.ndarray:
    k = np.arange(num_ceps)
    return (1.0 + 0.5 * q * np.sin(math.pi * k / q)).astype(np.float32)


def num_frames_ready(num_samples, frame_opts: FrameOptions):
    """Number of complete (snip-edges) frames for a given total sample count.
    Works on ints or traced jnp ints."""
    ws, sh = frame_opts.window_size, frame_opts.window_shift
    if isinstance(num_samples, (int, np.integer)):
        return 0 if num_samples < ws else (num_samples - ws) // sh + 1
    return jnp.where(num_samples < ws, 0, (num_samples - ws) // sh + 1)


_LOG_FLOOR = 1.1754944e-38  # FLT_MIN, Kaldi's log floor
_HIGHEST = jax.lax.Precision.HIGHEST


class FeatureExtractor:
    """MFCC / fbank extractor with precomputed matmul tables.

    `feature_type` in {"mfcc", "fbank"} mirrors the model-dir probing at
    reference src/model.cc:218-228.
    """

    def __init__(self, opts: MfccOptions | FbankOptions, pitch_opts=None):
        self.opts = opts
        self.is_mfcc = isinstance(opts, MfccOptions)
        fo = opts.frame_opts
        self.frame_opts = fo
        self.window = feature_window(fo)
        self.nfft = fo.padded_window_size
        self.dft_re, self.dft_im = dft_matrices(self.nfft)
        self.mel = mel_banks(opts.mel_opts, fo)
        if self.is_mfcc:
            self.dct = dct_matrix(opts.num_ceps, opts.mel_opts.num_bins)
            if opts.cepstral_lifter != 0.0:
                self.dct = self.dct * lifter_coeffs(opts.num_ceps, opts.cepstral_lifter)[None, :]
            self.dim = opts.num_ceps
        else:
            self.dim = opts.mel_opts.num_bins
        # optional online pitch appended to the base features (3 dims; the
        # reference adds Kaldi online pitch when conf/pitch.conf exists,
        # src/model.cc:265-276).  Frame emission is delayed by the pitch
        # lookahead so features stay chunk-invariant.
        self.pitch = None
        self.base_dim = self.dim
        self._pitch_la = 0
        if pitch_opts is not None:
            from .pitch import PitchOptions, StreamingPitch

            if isinstance(pitch_opts, dict):
                pitch_opts = PitchOptions(
                    sample_rate=fo.samp_freq, **pitch_opts)
            self.pitch = StreamingPitch(pitch_opts)
            self.dim += 3
            self._pitch_la = self.pitch.la16
        # jit entry points (shapes cached per (batch, samples))
        self._extract_jit = jax.jit(self._extract_impl)
        self._chunk_jit = jax.jit(self._extract_chunk_impl)

    @property
    def flush_pad_samples(self) -> int:
        """Zeros to append at end-of-input so lookahead-delayed frames (the
        pitch tail) are emitted; 0 when no pitch."""
        return self._pitch_la

    # ---------------- core frame computation (jittable) ----------------

    def _process_frames(self, frames, key):
        """frames: [..., n, window_size] -> feats [..., n, dim]."""
        opts, fo = self.opts, self.frame_opts
        x = frames.astype(jnp.float32)
        if fo.dither != 0.0 and key is not None:
            x = x + fo.dither * jax.random.normal(key, x.shape, dtype=jnp.float32)
        if fo.remove_dc_offset:
            x = x - jnp.mean(x, axis=-1, keepdims=True)
        raw_energy = jnp.sum(x * x, axis=-1)  # pre-window energy (raw_energy)
        c = fo.preemphasis_coefficient
        if c != 0.0:
            prev = jnp.concatenate([x[..., :1], x[..., :-1]], axis=-1)
            x = x - c * prev
        x = x * self.window
        pad = self.nfft - fo.window_size
        if pad:
            x = jnp.concatenate(
                [x, jnp.zeros(x.shape[:-1] + (pad,), x.dtype)], axis=-1
            )
        re = jnp.matmul(x, self.dft_re, precision=_HIGHEST,
                        preferred_element_type=jnp.float32)
        im = jnp.matmul(x, self.dft_im, precision=_HIGHEST,
                        preferred_element_type=jnp.float32)
        power = re * re + im * im
        mel_e = jnp.matmul(power, self.mel, precision=_HIGHEST,
                           preferred_element_type=jnp.float32)
        if self.is_mfcc:
            logmel = jnp.log(jnp.maximum(mel_e, _LOG_FLOOR))
            feats = jnp.matmul(logmel, self.dct, precision=_HIGHEST,
                               preferred_element_type=jnp.float32)
            if opts.use_energy:
                if opts.raw_energy:
                    e = jnp.log(jnp.maximum(raw_energy, _LOG_FLOOR))
                else:
                    e = jnp.log(jnp.maximum(jnp.sum(x * x, axis=-1), _LOG_FLOOR))
                if opts.energy_floor > 0.0:
                    e = jnp.maximum(e, math.log(opts.energy_floor))
                feats = feats.at[..., 0].set(e)
            return feats
        else:
            if not opts.use_power:
                mel_e = jnp.sqrt(jnp.maximum(mel_e, 0.0))
            if opts.use_log_fbank:
                mel_e = jnp.log(jnp.maximum(mel_e, _LOG_FLOOR))
            return mel_e

    # ---------------- offline (whole-utterance) ----------------

    def extract(self, wav, key: Optional[jax.Array] = None):
        """wav: [..., num_samples] -> feats [..., num_frames, dim].

        Whole-utterance path (batch transcription).  num_frames is static given
        num_samples (snip-edges), jitted per input shape.
        """
        n = num_frames_ready(wav.shape[-1], self.frame_opts)
        if n <= 0:
            return jnp.zeros(wav.shape[:-1] + (0, self.dim), jnp.float32)
        if self.pitch is not None:
            # pitch recursions carry state: run the streaming path over the
            # whole utterance in one chunk, with la16 trailing zeros so the
            # frame count matches the no-pitch num_frames_ready (offline
            # Kaldi computes end-of-stream frames against silence the same
            # way).  Chunk-invariance vs any streaming split is by
            # construction: same sequential recursions, same state.
            wav2 = np.asarray(wav, np.float32)
            squeeze = wav2.ndim == 1
            if squeeze:
                wav2 = wav2[None]
            B, N = wav2.shape
            pad = np.zeros((B, self._pitch_la), np.float32)
            wavp = np.concatenate([wav2, pad], axis=1)
            st = self.init_stream_state(B, wavp.shape[1])
            _, feats, _ = self.extract_chunk(st, jnp.asarray(wavp), key)
            feats = feats[:, :n]
            return feats[0] if squeeze else feats
        return self._extract_jit(wav, key)

    def _extract_impl(self, wav, key):
        fo = self.frame_opts
        n = num_frames_ready(wav.shape[-1], fo)
        idx = np.arange(n)[:, None] * fo.window_shift + np.arange(fo.window_size)[None, :]
        frames = wav[..., idx]  # gather -> [..., n, window_size]
        return self._process_frames(frames, key)

    # ---------------- streaming ----------------

    def stream_max_frames(self, chunk_samples: int) -> int:
        return chunk_samples // self.frame_opts.window_shift + 1

    def init_stream_state(self, batch: int, chunk_samples: int):
        """Carried state: raw-sample ring tail + counters.

        tail capacity = window_size + window_shift is enough: after emitting
        all complete frames, at most window_size - 1 unconsumed samples remain
        beyond the last frame start... we keep window_size + shift for slack.
        """
        cap = self._tail_cap(chunk_samples)
        st = {
            "tail": jnp.zeros((batch, cap), jnp.float32),
            "tail_len": jnp.zeros((batch,), jnp.int32),
            "total_samples": jnp.zeros((batch,), jnp.int64 if jax.config.jax_enable_x64 else jnp.int32),
            "frames_emitted": jnp.zeros((batch,), jnp.int32),
        }
        if self.pitch is not None:
            st["pitch"] = self.pitch.init_state(batch)
        return st

    def _tail_cap(self, chunk_samples: int) -> int:
        fo = self.frame_opts
        # Max unconsumed samples: window_size - shift (overlap) plus up to
        # shift-1 not yet forming a frame, plus slack if first chunk < window.
        cap = max(fo.window_size + fo.window_shift, chunk_samples + fo.window_size)
        if self.pitch is not None:
            # pitch delays frame emission by la16 samples and its FIR needs
            # W16 samples of retained left context
            cap += self._pitch_la + self.pitch.W16
        # round up to 128 lanes for layout friendliness
        return ((cap + 127) // 128) * 128

    def extract_chunk(
        self,
        state,
        chunk,
        key: Optional[jax.Array] = None,
        n_samples=None,
    ):
        """Streaming step. chunk: [B, S] fixed S -> (state', feats [B, F, dim],
        valid [B, F] bool) with F = stream_max_frames(S).  Masked frames are 0.
        n_samples: optional [B] int32 — only chunk[b, :n_samples[b]] is real
        data (prefix mask); defaults to S.
        """
        if n_samples is None:
            n_samples = jnp.full((chunk.shape[0],), chunk.shape[1], jnp.int32)
        return self._chunk_jit(state, chunk, key, n_samples)

    def _extract_chunk_impl(self, state, chunk, key, n_samples):
        fo = self.frame_opts
        B, S = chunk.shape
        F = self.stream_max_frames(S)
        cap = state["tail"].shape[1]
        ws, sh = fo.window_size, fo.window_shift

        tail, tail_len = state["tail"], state["tail_len"]
        total, emitted = state["total_samples"], state["frames_emitted"]
        n_s = n_samples.astype(jnp.int32)

        # concat tail + chunk into a working buffer [B, cap + S]
        buf = jnp.concatenate([tail, jnp.zeros((B, S), jnp.float32)], axis=1)
        # place chunk at position tail_len per row (vectorized dynamic update)
        col = jax.lax.broadcasted_iota(jnp.int32, (B, cap + S), 1)
        src_idx = jnp.clip(col - tail_len[:, None], 0, S - 1)
        chunk_g = jnp.take_along_axis(chunk.astype(jnp.float32), src_idx, axis=1)
        in_chunk = (col >= tail_len[:, None]) & (col < tail_len[:, None] + n_s[:, None])
        buf = jnp.where(in_chunk, chunk_g, buf)
        buf_len = tail_len + n_s

        new_total = total + n_s
        # with pitch, a frame is emitted only once its NCCF lookahead (plus
        # decimation-FIR halfwidth) is buffered — chunk-invariance
        total_ready = num_frames_ready(new_total - self._pitch_la, fo)
        n_new = (total_ready - emitted).astype(jnp.int32)  # <= F by construction

        # frame f (f in [0, F)) starts at buffer offset:
        #   global_start = (emitted + f) * sh ; buffer holds samples
        #   [new_total - buf_len, new_total) so offset = global_start - (new_total - buf_len)
        f_ids = jnp.arange(F, dtype=jnp.int32)
        start = (emitted[:, None] + f_ids[None, :]) * sh - (
            new_total[:, None] - buf_len[:, None]
        ).astype(jnp.int32)
        valid = f_ids[None, :] < n_new[:, None]
        start_c = jnp.clip(start, 0, cap + S - ws)
        gather_idx = start_c[:, :, None] + jnp.arange(ws, dtype=jnp.int32)[None, None, :]
        frames = jnp.take_along_axis(buf[:, None, :], gather_idx.reshape(B, -1)[:, None, :], axis=2)
        frames = frames.reshape(B, F, ws)
        feats = self._process_frames(frames, key)
        feats = jnp.where(valid[:, :, None], feats, 0.0)

        pitch_state = None
        if self.pitch is not None:
            # pitch windows start where the MFCC windows start; the buffer
            # holds the full lookahead because ready-counting delayed the
            # frames (start is UNclipped so pitch indexes real positions)
            pitch_state, pfeats = self.pitch.frame_features(
                state["pitch"], buf, start[:, 0], F, valid
            )
            pfeats = jnp.where(valid[:, :, None], pfeats, 0.0)
            feats = jnp.concatenate([feats, pfeats], axis=2)

        # new tail: keep samples from (emitted + n_new) * sh onward (minus
        # the FIR left margin the next pitch frame's decimation needs)
        consumed_global = (emitted + n_new) * sh
        if self.pitch is not None:
            consumed_global = jnp.maximum(consumed_global - self.pitch.W16, 0)
        keep_from = (consumed_global - (new_total - buf_len)).astype(jnp.int32)
        keep_from = jnp.clip(keep_from, 0, cap + S)
        new_tail_len = jnp.minimum(buf_len - keep_from, cap).astype(jnp.int32)
        tcol = jax.lax.broadcasted_iota(jnp.int32, (B, cap), 1)
        tsrc = jnp.clip(tcol + keep_from[:, None], 0, cap + S - 1)
        new_tail = jnp.take_along_axis(buf, tsrc, axis=1)
        new_tail = jnp.where(tcol < new_tail_len[:, None], new_tail, 0.0)

        new_state = {
            "tail": new_tail,
            "tail_len": new_tail_len,
            "total_samples": new_total,
            "frames_emitted": emitted + n_new,
        }
        if pitch_state is not None:
            new_state["pitch"] = pitch_state
        return new_state, feats, valid


# ---------------- CMVN ----------------


def sliding_window_cmn(feats, window: int = 300, center: bool = True, norm_vars: bool = False):
    """Sliding-window cepstral mean normalization (Kaldi SlidingWindowCmn with
    center=true), used for speaker-ID features at reference recognizer.cc:393-397.

    feats: [T, D] or [B, T, D].  Implemented with cumulative sums (no loops).
    """
    if feats.ndim == 2:
        return _swc_single(feats, window, center, norm_vars)
    return jax.vmap(lambda f: _swc_single(f, window, center, norm_vars))(feats)


def _swc_single(feats, window, center, norm_vars):
    T = feats.shape[0]
    cs = jnp.cumsum(feats, axis=0)
    cs = jnp.concatenate([jnp.zeros_like(cs[:1]), cs], axis=0)  # [T+1, D]
    cs2 = jnp.cumsum(feats * feats, axis=0)
    cs2 = jnp.concatenate([jnp.zeros_like(cs2[:1]), cs2], axis=0)
    t = jnp.arange(T)
    if center:
        lo = jnp.clip(t - window // 2, 0, T)
        hi = jnp.clip(lo + window, 0, T)
        lo = jnp.where(hi - lo < window, jnp.clip(hi - window, 0, T), lo)
    else:
        lo = jnp.clip(t - window + 1, 0, T)
        hi = t + 1
    cnt = (hi - lo).astype(jnp.float32)[:, None]
    mean = (cs[hi] - cs[lo]) / cnt
    out = feats - mean
    if norm_vars:
        var = (cs2[hi] - cs2[lo]) / cnt - mean * mean
        out = out / jnp.sqrt(jnp.maximum(var, 1e-10))
    return out


def global_cmvn(feats, stats: np.ndarray, norm_vars: bool = False):
    """Apply global CMVN from Kaldi-style stats matrix [2, D+1]
    (row 0: sum, count in last col; row 1: sum-squares).  Reference loads these
    at model.cc:265-269."""
    count = stats[0, -1]
    mean = stats[0, :-1] / count
    out = feats - mean
    if norm_vars:
        var = stats[1, :-1] / count - mean * mean
        out = out / np.sqrt(np.maximum(var, 1e-10))
    return out
