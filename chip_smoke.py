#!/usr/bin/env python3
"""End-to-end smoke test of the recogniser on one NVIDIA GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the multi-device path only

Drives the main path once through the entry points users call, at the full
width of the flagship configuration (the bench.py operating point: TDNN-F
with 11 layers, hidden 512, bottleneck 96, prefinal 192, bf16 matmuls;
6008 pdfs; a 2M-state graph with a 100k-word vocabulary; max-active 7000,
beam 13, lattice-beam 6).  Weights, graph and audio come from fixed seeds.
Everything runs in this one process: a JAX process reserves most of the
card's memory, so a second one could not share it.

Phases, in order; any failure stops the run with a non-zero exit:

  1. device       refuse to run unless JAX's default device is a GPU
  2. native       build core/libvosk_tpu_core.so, check it loads
  3. kernels      every device kernel of the path against its plain
                  reference at real widths (tolerances printed with reasons)
  4. accuracy     toy model trained here; WER on a held-out corpus through
                  Model + KaldiRecognizer; a runtime-grammar recogniser
  5. main path    flagship model saved and loaded through Model(dir);
                  streaming KaldiRecognizers, BatchModel/BatchRecognizer,
                  the websocket server, FusedPipeline.run_scan at B=96
  6. gpu tests    the tests marked `gpu`, run in this process

The last line of standard output is one JSON object naming the device; the
line before it is nvidia-smi's card name and power limit.
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / ".chip_smoke"   # models written by the run (gitignored)
sys.path.insert(0, str(ROOT))

FLAGSHIP = dict(num_states=2_000_000, num_pdfs=6008, hidden=512,
                max_active=7000, realistic=True, num_words=100_000)


@contextlib.contextmanager
def phase(name: str):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def show(label: str, **values) -> None:
    print(f"   {label}: " + ", ".join(f"{k}={v}" for k, v in values.items()),
          flush=True)


def peak_bytes() -> int:
    import jax

    return jax.devices()[0].memory_stats()["peak_bytes_in_use"]


def timed(fn, *args):
    """(result, seconds) of fn(*args) with every output ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


# ------------------------------------------------------------ comparisons
#
# Each check runs one device kernel of the main path against its plain
# reference, asserts the stated tolerance and returns what it measured.
# tests/test_gpu.py runs the same checks at test sizes.


def check_gather(B=96, P=6008, E=28_000, K=7000, seed=0) -> dict:
    """The frame step's gathers (ops/gather.py): the acoustic lookup
    ll[b, pdf] at [B, P] -> [B, E] float32, and the per-token payload
    gather at [B, K] int32 (full 32-bit range).  Tolerance: bit-exact,
    since a gather moves values and computes nothing."""
    import jax

    from vosk_tpu.ops.gather import gather_rows

    rng = np.random.default_rng(seed)
    ll = rng.standard_normal((B, P)).astype(np.float32)
    pdf = rng.integers(0, P, (B, E)).astype(np.int32)
    fn = jax.jit(gather_rows)
    got = np.asarray(fn(ll, pdf))
    np.testing.assert_array_equal(got, np.take_along_axis(ll, pdf, axis=1))
    tsil = rng.integers(-(2**31), 2**31 - 1, (B, K), dtype=np.int64)
    tsil = tsil.astype(np.int32)
    prev = rng.integers(0, K, (B, K)).astype(np.int32)
    got = np.asarray(fn(tsil, prev))
    np.testing.assert_array_equal(got, np.take_along_axis(tsil, prev, axis=1))
    return {"acoustic": f"[{B},{P}]->[{B},{E}] f32 bit-exact",
            "payload": f"[{B},{K}] i32 bit-exact"}


def _noisy_audio(B: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    f0 = rng.uniform(100.0, 1000.0, (B, 1))
    wav = 3000 * np.sin(2 * np.pi * f0 * t) + 500 * rng.standard_normal((B, n))
    return wav.astype(np.float32)


def check_mfcc(model, B=96, seconds=0.48, tol=1e-3) -> dict:
    """MFCC (ops/features.py: DFT, mel and DCT as float32 matmuls at
    precision HIGHEST) against the independent float64 numpy FFT reference
    of tests/test_features.py, dither 0.  Tolerance: max abs diff <= tol,
    float32 rounding of a 512-point DFT through log and DCT.  Also reports
    the diff the same extractor gives at the backend's default precision
    (not asserted: that is what HIGHEST is there to prevent)."""
    sys.path.insert(0, str(ROOT / "tests"))
    from test_features import numpy_reference

    from vosk_tpu.ops import features as F

    wav = _noisy_audio(B, int(seconds * 16000), seed=1)
    want = np.stack([numpy_reference(w, model.feature_extractor().opts)
                     for w in wav])
    got = np.asarray(model.feature_extractor().extract(wav))
    diff = float(np.abs(got - want).max())
    saved = F._HIGHEST
    F._HIGHEST = None   # a fresh extractor traces at default precision
    try:
        got_default = np.asarray(model.feature_extractor().extract(wav))
    finally:
        F._HIGHEST = saved
    diff_default = float(np.abs(got_default - want).max())
    assert got.shape == want.shape, (got.shape, want.shape)
    assert diff <= tol, f"MFCC max abs diff {diff} > {tol}"
    return {"shape": list(got.shape), "max_abs_diff_highest": diff,
            "max_abs_diff_default_precision": diff_default, "tol": tol,
            "max_abs_value": float(np.abs(want).max())}


def check_am(model, B=8, frames=150, rel_tol=1e-2, argmax_min=0.99) -> dict:
    """TDNN-F forward (bf16 operands, f32 accumulation) on the GPU against
    the same jitted forward on the CPU backend of this process.
    Tolerances: max abs diff <= rel_tol * max |output| (bf16 keeps 8
    mantissa bits and the two backends sum in different orders), and the
    per-frame argmax pdf agreeing on >= argmax_min of frames."""
    import jax

    cpu = jax.devices("cpu")[0]
    am = model.make_am()
    feats = np.random.default_rng(2).standard_normal(
        (B, frames, model.config.am["feat_dim"])).astype(np.float32)
    fwd = jax.jit(am.forward_utterance)
    out_gpu = np.asarray(fwd(am.params, feats))
    with jax.default_device(cpu):
        out_cpu = np.asarray(fwd(jax.device_put(am.params, cpu),
                                 jax.device_put(feats, cpu)))
    diff = float(np.abs(out_gpu - out_cpu).max())
    scale = float(np.abs(out_cpu).max())
    agree = float(np.mean(out_gpu.argmax(-1) == out_cpu.argmax(-1)))
    assert diff <= rel_tol * scale, f"AM diff {diff} > {rel_tol} * {scale}"
    assert agree >= argmax_min, f"AM argmax agreement {agree} < {argmax_min}"
    return {"shape": list(out_gpu.shape), "max_abs_diff": diff,
            "max_abs_output": scale, "rel": diff / scale,
            "argmax_agreement": agree}


def check_token_passing(model, dec, B=2, T=30, rel_tol=1e-5) -> dict:
    """Token passing (ops/viterbi.py, the production v4 step) on the GPU
    against the same program on the CPU backend, on structured loglikes
    (random graph walks plus noise).  Tolerances: tracebacks
    word-identical, per-frame pdf alignments identical; best costs within
    rel_tol (float32 sums of a few hundred terms, fused differently by the
    two compilers).  Whether the final frontiers are bit-identical is
    reported, not asserted."""
    import jax

    from vosk_tpu.utils.benchdata import make_plausible_loglikes

    P = model.config.am["num_pdfs"]
    ll = make_plausible_loglikes(model.graph, P, B, T, snr=2.0, seed=3)
    ll = np.ascontiguousarray(ll.swapaxes(0, 1))   # [B, T, P]
    valid = np.ones((B, T), bool)
    f_g, r_g, _, _ = dec.decode_chunk(dec.init_frontier(B), ll, valid)

    cpu = jax.devices("cpu")[0]
    gpu_tables = dec.tables
    dec.tables = jax.device_put(gpu_tables, cpu)
    try:
        with jax.default_device(cpu):
            f_c, r_c, _, _ = dec.decode_chunk(
                jax.device_put(dec.init_frontier(B), cpu),
                jax.device_put(ll, cpu), jax.device_put(valid, cpu))
            f_c, r_c = jax.device_get((f_c, r_c))
    finally:
        dec.tables = gpu_tables

    worst = 0.0
    words = []
    for ch in range(B):
        c_g, w_g, a_g = dec.traceback([r_g], f_g, ch)
        c_c, w_c, a_c = dec.traceback([r_c], f_c, ch)
        assert w_g == w_c, f"channel {ch}: words differ {w_g} vs {w_c}"
        assert a_g == a_c, f"channel {ch}: pdf alignments differ"
        assert np.isfinite(c_g), f"channel {ch}: no surviving path"
        worst = max(worst, abs(c_g - c_c) / max(abs(c_c), 1e-30))
        words.append(len(w_g))
    assert worst <= rel_tol, f"best-cost rel diff {worst} > {rel_tol}"
    live = np.isfinite(np.asarray(f_g["cost"])).sum(axis=1)
    same_frontier = all(
        np.array_equal(np.asarray(f_g[k]), np.asarray(f_c[k])) for k in f_g)
    return {"channels": B, "frames": T, "K": dec.K, "E": dec.E,
            "states": dec.S, "live_tokens": live.tolist(),
            "words_per_channel": words, "alignment_frames": len(a_g),
            "max_rel_cost_diff": worst,
            "frontier_bit_identical": same_frontier}


def check_v4_small() -> dict:
    """v4 step, exact3 and packed16 rows, against the exact host decoder
    graph/ref_decoder.ref_decode on the small graphs of
    tests/test_viterbi_v4.py.  Tolerances as there: words identical, cost
    rel 1e-4 (exact3) or 3e-3 (packed16: float16 graph weights)."""
    sys.path.insert(0, str(ROOT / "tests"))
    from test_arrayopt import random_fst_unlabeled_eps

    from vosk_tpu.graph.arrayopt import prepare_graph_v4
    from vosk_tpu.graph.fst import flatten_fst
    from vosk_tpu.graph.ref_decoder import ref_decode
    from vosk_tpu.ops.viterbi import BatchViterbi, DecodeParams

    n = 0
    for seed in (0, 1, 2, 5):
        fst = random_fst_unlabeled_eps(seed)
        g = prepare_graph_v4(flatten_fst(fst), M=4)
        ll = np.random.default_rng(50 + seed).standard_normal(
            (15, 6)).astype(np.float32) * 2
        ref_cost, ref_ols, _ = ref_decode(fst, ll)
        for pack, rel in (("exact3", 1e-4), ("packed16", 3e-3)):
            dec = BatchViterbi(g, DecodeParams(beam=1e9, max_active=128),
                               frame_step="v4", pack=pack, padded_max_out=64)
            fr, recs, _, _ = dec.decode_chunk(dec.init_frontier(2),
                                              np.stack([ll, ll]))
            for ch in range(2):
                cost, ols, _ = dec.traceback([recs], fr, ch)
                assert ols == ref_ols, (seed, pack, ols, ref_ols)
                assert abs(cost - ref_cost) <= rel * abs(ref_cost), (
                    seed, pack, cost, ref_cost)
                n += 1
    return {"decodes_matching_reference": n}


# ----------------------------------------------------------------- phases


def phase_device() -> dict:
    from vosk_tpu.utils import compile_cache, device

    cache = compile_cache.enable()
    dev = device.require_gpu()
    smi = device.smi_name_and_power()
    import jax

    show("jax", version=jax.__version__, platform=dev["platform"],
         kind=repr(dev["kind"]), count=dev["count"])
    show("nvidia-smi", name_and_power_limit=repr(smi))
    show("env", XLA_FLAGS=repr(os.environ.get("XLA_FLAGS", "")),
         compile_cache=cache)
    return dev


def phase_native() -> None:
    subprocess.run(["make", "-C", str(ROOT / "core"), "libvosk_tpu_core.so"],
                   check=True, stdout=subprocess.DEVNULL)
    from vosk_tpu.runtime import native_lattice

    assert native_lattice.available(), "libvosk_tpu_core.so did not load"
    show("native lattice library", loaded=True)


def phase_kernels(model) -> None:
    show("gather", **check_gather())
    show("mfcc", **check_mfcc(model))
    show("am forward", **check_am(model))
    dec = model.shared_decoder()
    show("token passing (2M-state graph)", **check_token_passing(model, dec))
    show("v4 vs ref_decode", **check_v4_small())


def _pcm16(wav: np.ndarray) -> bytes:
    return np.clip(wav, -32768, 32767).astype("<i2").tobytes()


def _decode_words(rec, data: bytes, chunk_bytes: int = 4000) -> list:
    words = []
    for i in range(0, len(data), chunk_bytes):
        if rec.AcceptWaveform(data[i: i + chunk_bytes]):
            words += json.loads(rec.Result())["text"].split()
        else:
            json.loads(rec.PartialResult())
    return words + json.loads(rec.FinalResult())["text"].split()


def phase_accuracy() -> None:
    import vosk_tpu
    from vosk_tpu.utils import toydata
    from vosk_tpu.utils.wer import score_corpus

    toy_dir = WORK / "toy_model"
    _, secs = timed(lambda: toydata.build_toy_model(str(toy_dir),
                                                    train_steps=400))
    show("toy model", train_steps=400, build_s=f"{secs:.1f}")
    model = vosk_tpu.Model(str(toy_dir))
    # the held-out corpus of tests/test_wer_parity.py
    rng = np.random.default_rng(5150)
    refs, hyps = [], []
    t0 = time.perf_counter()
    for i in range(8):
        ws = [toydata.WORDS[rng.integers(0, len(toydata.WORDS))]
              for _ in range(4)]
        data = _pcm16(toydata.make_test_wav(ws, seed=900 + i))
        refs.append(ws)
        hyps.append(_decode_words(vosk_tpu.KaldiRecognizer(model, 16000),
                                  data))
    counts = score_corpus(refs, hyps)
    show("held-out WER", **counts.as_dict(), bound=0.10,
         decode_s=f"{time.perf_counter() - t0:.1f}")
    assert counts.wer <= 0.10, (refs, hyps)
    rec = vosk_tpu.KaldiRecognizer(
        model, 16000, json.dumps(["one two", "three four"]))
    rec.AcceptWaveform(_pcm16(toydata.make_test_wav(["one", "two"], seed=15)))
    text = json.loads(rec.FinalResult())["text"]
    show("runtime grammar", phrases=["one two", "three four"], heard=text)
    assert text == "one two", text


def _stream(recs, data: bytes, chunk_bytes: int) -> list:
    finals = []
    for r in recs:
        for i in range(0, len(data), chunk_bytes):
            if r.AcceptWaveform(data[i: i + chunk_bytes]):
                json.loads(r.Result())
            else:
                json.loads(r.PartialResult())
        finals.append(json.loads(r.FinalResult()))
    return finals


def _ws_sessions(model, data: bytes, chunk_bytes: int, n: int) -> list:
    """n client sessions against an ASRServer on loopback, the server on
    its own event loop in a thread of this process."""
    from vosk_tpu.server import wsproto
    from vosk_tpu.server.ws import ASRServer

    loop = asyncio.new_event_loop()
    server = loop.run_until_complete(
        wsproto.serve(ASRServer(model).handle, "127.0.0.1", 0))
    port = server.sockets[0].getsockname()[1]
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    async def session():
        async with wsproto.connect(f"ws://127.0.0.1:{port}") as ws:
            await ws.send(json.dumps({"config": {"sample_rate": 16000}}))
            for i in range(0, len(data), chunk_bytes):
                await ws.send(data[i: i + chunk_bytes])
                json.loads(await ws.recv())
            await ws.send(json.dumps({"eof": 1}))
            return json.loads(await ws.recv())

    async def clients():
        return await asyncio.gather(*[session() for _ in range(n)])

    try:
        return asyncio.run(clients())
    finally:
        async def close():
            server.close()
            await server.wait_closed()

        asyncio.run_coroutine_threadsafe(close(), loop).result(timeout=60)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=60)
        loop.close()


def phase_main_path(model) -> None:
    import jax

    import vosk_tpu
    from vosk_tpu.io.native import save_model
    from vosk_tpu.runtime.pipeline import FusedPipeline
    from vosk_tpu.utils.benchdata import structured_ll_bias

    cfg = model.config
    assert (cfg.beam, cfg.max_active, cfg.lattice_beam) == (
        13.0, FLAGSHIP["max_active"], 6.0)
    model_dir = WORK / "flagship_model"
    t0 = time.perf_counter()
    save_model(model_dir, cfg, model.am_params, model.graph, model.words,
               model.phones, None, model.phone_of_pdf, model.silence_pdfs,
               model.topology)
    loaded = vosk_tpu.Model(str(model_dir))
    show("save + Model(dir)", s=f"{time.perf_counter() - t0:.1f}",
         states=loaded._model.graph.num_states)

    seconds, chunk = 3.0, 6400          # 0.2 s of 16 kHz PCM16
    rng = np.random.default_rng(4)
    data = _pcm16(rng.standard_normal(int(seconds * 16000)) * 2000)

    plain = vosk_tpu.KaldiRecognizer(loaded, 16000)
    full = vosk_tpu.KaldiRecognizer(loaded, 16000)
    full.SetWords(True)
    full.SetMaxAlternatives(3)
    _, first = timed(plain.AcceptWaveform, data[:chunk])
    plain.Reset()
    finals, wall = timed(_stream, [plain, full], data, chunk)
    assert "text" in finals[0] and "alternatives" in finals[1], finals
    show("KaldiRecognizer x2", audio_s=seconds, chunk_s=0.2,
         first_call_s=f"{first:.1f}", wall_s=f"{wall:.2f}",
         peak_bytes=peak_bytes())

    def batch():
        bm = vosk_tpu.BatchModel(str(model_dir))
        recs = [vosk_tpu.BatchRecognizer(bm, 16000) for _ in range(8)]
        for i in range(0, len(data), chunk):
            for r in recs:
                r.AcceptWaveform(data[i: i + chunk])
        for r in recs:
            r.FinishStream()
        bm.Wait()
        return [json.loads(r.Result()) for r in recs]

    results, wall = timed(batch)
    assert all("text" in r for r in results), results
    show("BatchModel + 8 BatchRecognizer", audio_s=seconds,
         wall_s_incl_load_and_compile=f"{wall:.1f}", peak_bytes=peak_bytes())

    finals, wall = timed(_ws_sessions, loaded, data, chunk, 2)
    assert all("text" in f for f in finals), finals
    show("websocket server, 2 sessions", wall_s=f"{wall:.2f}",
         peak_bytes=peak_bytes())

    B, drive_s = 96, 4.0
    pipe = FusedPipeline(model, batch=B, chunk_seconds=0.48,
                         collect_records=True, lattice_records=True)
    S = pipe.chunk_samples
    n_chunks = int(drive_s * cfg.sample_rate) // S
    audio = jax.device_put(
        (rng.standard_normal((n_chunks, B, S)) * 500).astype(np.float32))
    lb = structured_ll_bias(pipe, n_chunks)   # plausible-path beam dynamics
    state = pipe.init_state()
    (state, recs, best), first = timed(pipe.run_scan, state, audio, None, lb)
    del recs
    (state, recs, best), second = timed(pipe.run_scan, state, audio, None, lb)
    assert np.isfinite(np.asarray(best)[-1]).all(), "bulk drive lost a channel"
    assert recs["lat_pm"].shape[2] == B
    frames = int(lb.shape[0] * lb.shape[2])
    show("FusedPipeline.run_scan", channels=B, chunk_s=0.48,
         drive_audio_s=n_chunks * 0.48, drives=2,
         first_drive_s=f"{first:.2f}", second_drive_s=f"{second:.3f}",
         compile_s_approx=f"{first - second:.1f}",
         ms_per_frame=f"{second / frames * 1e3:.3f}",
         peak_bytes=peak_bytes())
    jitted = next(iter(pipe._scan_jits.values()))
    mem = jitted.lower(pipe.params, pipe.dec.tables, state, audio,
                       jax.numpy.full(audio.shape[:2], S, jax.numpy.int32),
                       lb).compile().memory_analysis()
    show("fused step memory_analysis", **{
        k: getattr(mem, k) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(mem, k)})
    shutil.rmtree(model_dir)


class _Outcomes:
    """pytest plugin: counts test outcomes of the in-process run."""

    def __init__(self):
        self.counts = {"passed": 0, "failed": 0, "skipped": 0}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] = self.counts.get(report.outcome,
                                                          0) + 1


def phase_gpu_tests() -> None:
    import pytest

    outcomes = _Outcomes()
    rc = pytest.main(["-q", "-m", "gpu", "--require-gpu",
                      "-p", "no:cacheprovider", "--rootdir", str(ROOT),
                      str(ROOT / "tests" / "test_gpu.py")],
                     plugins=[outcomes])
    show("gpu-marked tests", rc=int(rc), **outcomes.counts)
    assert rc == 0 and outcomes.counts["passed"] > 0, outcomes.counts
    assert outcomes.counts["skipped"] == 0, outcomes.counts


def run_one_card() -> dict:
    from vosk_tpu.utils.benchdata import make_bench_model

    with phase("1/6 device"):
        dev = phase_device()
    with phase("2/6 native host library"):
        phase_native()
    with phase("3/6 kernels against the plain reference"):
        model, secs = timed(lambda: make_bench_model(**FLAGSHIP))
        show("flagship model", build_s=f"{secs:.1f}", **FLAGSHIP)
        phase_kernels(model)
    with phase("4/6 accuracy witness"):
        phase_accuracy()
    with phase("5/6 main path at full width"):
        phase_main_path(model)
    with phase("6/6 gpu-marked tests"):
        phase_gpu_tests()
    return dev


def run_four_cards() -> dict:
    import jax

    from vosk_tpu.parallel.check import check_multichip

    with phase("device"):
        dev = phase_device()
        assert dev["count"] >= 4, f"--four-cards needs 4 GPUs, has {dev}"
    with phase("multi-device path against the 1-device path"):
        summary, secs = timed(check_multichip, jax.devices()[:4])
        show("check_multichip", wall_s=f"{secs:.1f}", **summary)
    return dict(dev, count=4)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the multi-device path, on four cards")
    args = p.parse_args(argv)
    if not __debug__:
        sys.exit("chip_smoke.py checks with assert: run it without -O")
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    try:
        dev = run_four_cards() if args.four_cards else run_one_card()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    from vosk_tpu.utils import device

    print(device.smi_name_and_power(), flush=True)
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
