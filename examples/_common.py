"""Shared helpers for the runnable examples.

Mirrors the reference's python/example/ scripts (each demonstrates one
feature of the API) adapted to vosk_tpu: a toy model is trained on first
use (no model downloads in the build image; on a networked host,
`Model(lang=...)` with VOSK_TPU_ALLOW_DOWNLOAD=1 resolves from the zoo).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

TOY_DIR = os.environ.get("VOSK_TPU_EXAMPLE_MODEL", "/tmp/vosk_tpu_toy_model_v1")


def ensure_model():
    if not os.path.exists(os.path.join(TOY_DIR, "vosk_tpu_model.json")):
        from vosk_tpu.utils import toydata

        print(f"training toy model -> {TOY_DIR} (~30 s, once)")
        toydata.build_toy_model(TOY_DIR, train_steps=400)
    return TOY_DIR


def example_wav(words=("five", "one", "seven"), seed=1):
    """16 kHz mono s16 PCM bytes of a synthesized utterance (the stand-in
    for the reference's test.wav)."""
    import numpy as np

    from vosk_tpu.utils import toydata

    wav = toydata.make_test_wav(list(words), seed=seed)
    return np.clip(wav, -32768, 32767).astype("<i2").tobytes()
