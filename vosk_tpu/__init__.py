"""vosk_tpu — speech recognition in JAX with the vosk-api surface.

Drop-in parity with the reference Python binding (python/vosk/__init__.py):
`Model`, `SpkModel`, `KaldiRecognizer`, `BatchModel`, `BatchRecognizer`,
`SetLogLevel`, `GpuInit` — same method names and JSON result formats, backed
by jax/XLA on an accelerator instead of a Kaldi C library.
"""
from __future__ import annotations

import os
from pathlib import Path

from .utils.logging import set_log_level as _set_log_level

# model search path parity (reference python/vosk/__init__.py:13-15)
MODEL_DIRS = [
    os.getenv("VOSK_MODEL_PATH"),
    Path("/usr/share/vosk"),
    Path.home() / "AppData/Local/vosk",
    Path.home() / ".cache/vosk",
]


def _resolve_model_path(model_path=None, model_name=None, lang=None):
    from re import match

    if model_path is not None:
        return model_path
    for directory in MODEL_DIRS:
        if directory is None or not Path(directory).exists():
            continue
        for entry in sorted(os.listdir(directory)):
            if model_name is not None and entry == model_name:
                return Path(directory, entry)
            if lang is not None and match(rf"vosk-model(-small)?-{lang}", entry):
                return Path(directory, entry)
    # model-zoo resolution (reference python/vosk/__init__.py:61-121):
    # name/lang -> model-list.json -> zip download -> cache dir.  Gated
    # behind VOSK_TPU_ALLOW_DOWNLOAD because the build/CI environment has
    # zero egress; the resolver logic is real and unit-tested against a
    # faked transport (tests/test_download.py).
    if os.environ.get("VOSK_TPU_ALLOW_DOWNLOAD"):
        p = _download_model(model_name=model_name, lang=lang)
        if p is not None:
            return p
    what = model_name if model_name is not None else lang
    raise Exception(
        f"model {what} does not exist (downloads are disabled; set "
        "VOSK_MODEL_PATH / pass model_path, or export "
        "VOSK_TPU_ALLOW_DOWNLOAD=1 on a host with network access)"
    )


MODEL_PRE_URL = "https://alphacephei.com/vosk/models/"
MODEL_LIST_URL = MODEL_PRE_URL + "model-list.json"


def list_models(urlopen=None):
    """The zoo index (reference list_models, __init__.py:34)."""
    import json as _json
    from urllib.request import urlopen as _urlopen

    with (urlopen or _urlopen)(MODEL_LIST_URL) as r:
        return _json.loads(r.read().decode("utf-8"))


def _download_model(model_name=None, lang=None, urlopen=None,
                    urlretrieve=None):
    """Resolve a zoo model by exact name or by language (smallest
    non-obsolete per-lang model, matching the reference's policy at
    python/vosk/__init__.py:83-97), download the zip into the first
    writable MODEL_DIRS cache entry, unpack, and return the directory."""
    import zipfile
    from pathlib import Path
    from urllib.request import urlretrieve as _urlretrieve

    models = list_models(urlopen=urlopen)
    if model_name is not None:
        found = [m["name"] for m in models if m["name"] == model_name]
    else:
        found = [
            m["name"] for m in models
            if m.get("lang") == lang and m.get("type") == "small"
            and str(m.get("obsolete", "false")) == "false"
        ]
    if not found:
        return None
    name = found[0]
    cache = None
    for directory in MODEL_DIRS:
        if directory is None:
            continue
        try:
            Path(directory).mkdir(parents=True, exist_ok=True)
            cache = Path(directory)
            break
        except OSError:
            continue
    if cache is None:
        return None
    target = cache / name
    if not target.exists():
        zpath = str(target) + ".zip"
        (urlretrieve or _urlretrieve)(MODEL_PRE_URL + name + ".zip", zpath)
        with zipfile.ZipFile(zpath) as z:
            z.extractall(cache)
        os.remove(zpath)
    return target


class Model:
    """Static recognition model, shareable across recognizers
    (vosk_api.h:24-27)."""

    def __init__(self, model_path=None, model_name=None, lang=None):
        from pathlib import Path as _P

        from .io import native

        path = _resolve_model_path(model_path, model_name, lang)
        self._model = native.load_any(path)
        self._decoder_cache: dict = {}

    def vosk_model_find_word(self, word: str) -> int:
        return self._model.find_word(word)

    def FindWord(self, word: str) -> int:
        return self._model.find_word(word)


class SpkModel:
    """Speaker identification model (vosk_api.h:30-32)."""

    def __init__(self, model_path):
        from .models.xvector import SpkModel as _SpkModel

        self._model = _SpkModel.load(model_path)


class KaldiRecognizer:
    """Streaming recognizer with the reference binding's API
    (python/vosk/__init__.py:134-183): constructors (model, rate),
    (model, rate, spk_model), (model, rate, grammar_json)."""

    def __init__(self, *args):
        from .runtime.recognizer import Recognizer

        if len(args) == 2:
            model, rate = args
            self._rec = Recognizer(model._model, float(rate))
        elif len(args) == 3 and isinstance(args[2], SpkModel):
            model, rate, spk = args
            self._rec = Recognizer(model._model, float(rate), spk_model=spk._model)
        elif len(args) == 3 and isinstance(args[2], str):
            model, rate, grammar = args
            self._rec = Recognizer(model._model, float(rate), grammar=grammar)
        else:
            raise TypeError("Unknown arguments")

    def SetMaxAlternatives(self, max_alternatives: int) -> None:
        self._rec.set_max_alternatives(max_alternatives)

    def SetWords(self, enable_words: bool) -> None:
        self._rec.set_words(enable_words)

    def SetPartialWords(self, enable_partial_words: bool) -> None:
        self._rec.set_partial_words(enable_partial_words)

    def SetNLSML(self, enable_nlsml: bool) -> None:
        self._rec.set_nlsml(enable_nlsml)

    def SetSpkModel(self, spk_model: SpkModel) -> None:
        self._rec.set_spk_model(spk_model._model)

    def AcceptWaveform(self, data) -> int:
        try:
            return 1 if self._rec.accept_waveform(data) else 0
        except Exception:
            raise Exception("Failed to process waveform")

    def Result(self) -> str:
        return self._rec.result()

    def PartialResult(self) -> str:
        return self._rec.partial_result()

    def FinalResult(self) -> str:
        return self._rec.final_result()

    def Reset(self) -> None:
        self._rec.reset()

    def GetMetrics(self) -> dict:
        """vosk_tpu extension: per-stage timing report (features /
        acoustic_model / decoder / finishing seconds, xRT)."""
        return self._rec.get_metrics()


def SetLogLevel(level: int) -> None:
    """vosk_set_log_level parity (vosk_api.h:287-294)."""
    _set_log_level(level)


def GpuInit() -> None:
    """Device init parity (vosk_api.h:296-301): jax initializes devices
    lazily; this just forces backend initialization."""
    import jax

    jax.devices()


def GpuThreadInit() -> None:
    """No-op: jax manages per-thread device state (vosk_api.h:303-308)."""


def list_local_models():
    """List locally cached model directories."""
    for directory in MODEL_DIRS:
        if directory is None or not Path(directory).exists():
            continue
        for entry in sorted(os.listdir(directory)):
            print(entry)


def list_languages(urlopen=None):
    """Languages available in the zoo index (reference list_languages)."""
    langs = sorted({m.get("lang", "?") for m in list_models(urlopen=urlopen)})
    for lang in langs:
        print(lang)
    return langs


from .runtime.batch import BatchModel, BatchRecognizer  # noqa: E402,F401
