"""C ABI end-to-end: compile the C smoke test against libvosk_tpu.so and
decode a WAV from pure C (reference analogue: c/test_vosk.c)."""
import json
import os
import subprocess
from pathlib import Path

import numpy as np
import pytest

from vosk_tpu.io.wav import write_wav
from vosk_tpu.utils import toydata

ROOT = Path(__file__).resolve().parents[1]
TOY_DIR = "/tmp/vosk_tpu_toy_model_v1"


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    if not os.path.exists(os.path.join(TOY_DIR, "vosk_tpu_model.json")):
        toydata.build_toy_model(TOY_DIR, train_steps=400)
    subprocess.run(
        ["make", "-C", str(ROOT / "core"), "test_vosk"], check=True,
        capture_output=True,
    )
    wav_path = tmp_path_factory.mktemp("cabi") / "test.wav"
    write_wav(wav_path, toydata.make_test_wav(["five", "one", "seven"], seed=70), 16000)
    return str(ROOT / "core" / "test_vosk"), str(wav_path)


def test_bindings_symbol_parity(artifacts):
    """Every vosk_* symbol referenced by the shipped Node/Go/Java/C#
    binding sources must be exported by libvosk_tpu.so — validates the
    binding surface without those runtimes (zero-egress image)."""
    import re

    exported = set(
        re.findall(
            r"\b(vosk_\w+)\b",
            subprocess.run(
                ["nm", "-D", str(ROOT / "core" / "libvosk_tpu.so")],
                capture_output=True, text=True, check=True,
            ).stdout,
        )
    )
    binding_files = list((ROOT / "bindings").rglob("*.*"))
    assert binding_files
    referenced = set()
    for f in binding_files:
        if f.suffix in (".js", ".go", ".java", ".cs", ".swift"):
            referenced |= set(re.findall(r"\b(vosk_\w+)\b", f.read_text()))
    assert referenced, "no binding sources found"
    referenced -= {"vosk_api", "vosk_tpu"}  # header/library names, not symbols
    missing = referenced - exported
    assert not missing, f"bindings reference unexported symbols: {missing}"
    assert "vosk_recognizer_set_word_times" in referenced


def test_c_abi_multithreaded(artifacts):
    """The reference API contract: one model, N recognizers in N threads
    (vosk_api.h:24-27).  Drives the ABI concurrently from pthreads (a
    non-Python consumer), asserts every thread decodes identically, and
    prints single vs aggregate throughput (quantifying the GIL cost of the
    embedded-CPython shim; see the THROUGHPUT line in the output)."""
    binary, wav = artifacts
    subprocess.run(
        ["make", "-C", str(ROOT / "core"), "test_vosk_mt"], check=True,
        capture_output=True,
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [str(ROOT / "core" / "test_vosk_mt"), TOY_DIR, wav, "4"],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "RESULT" in out.stdout and "THROUGHPUT" in out.stdout
    final = json.loads(out.stdout.split("RESULT ", 1)[1].splitlines()[0])
    assert final["text"] == "five one seven"
    print(out.stdout.splitlines()[-1])  # throughput record for the log


def test_c_abi_decode(artifacts):
    binary, wav = artifacts
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [binary, TOY_DIR, wav], env=env, capture_output=True, text=True,
        timeout=400,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [l for l in out.stdout.strip().splitlines() if l.startswith("{")]
    assert lines
    final = json.loads(lines[-1])
    assert final["text"] == "five one seven"
    assert "result" in final  # words enabled in the C test
