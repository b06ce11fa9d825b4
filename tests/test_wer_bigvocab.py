"""WER parity at scale: a generated 600-word language with homophones and
a few-thousand-state graph (round-4 review: stop resting accuracy claims on
the 5-word toy corpus; reference QA analogue training/RESULTS.txt:1-2).

Asserts on the SAME axes as tests/test_wer_parity.py but at a vocabulary
and graph scale where beam competition is real:
  (a) v4 production step vs v3 oracle — word-identical
  (b) adaptive max-active ladder vs fixed-K — bounded WER delta (documented)
  (c) absolute WER on held-out utterances — the model actually decodes
"""
import os

import numpy as np
import pytest

import vosk_tpu
from vosk_tpu.ops.viterbi import BatchViterbi, DecodeParams
from vosk_tpu.utils import toydata
from vosk_tpu.utils.wer import score_corpus

BIG_DIR = "/tmp/vosk_tpu_big_model_v1"
N_UTTS = 12
WORDS_PER_UTT = 5


@pytest.fixture(scope="module")
def lang():
    return toydata.build_big_language(n_words=600, n_phones=14, seed=0)


@pytest.fixture(scope="module")
def model(lang):
    if not os.path.exists(os.path.join(BIG_DIR, "vosk_tpu_model.json")):
        toydata.build_big_model(BIG_DIR, lang, train_steps=500)
    return vosk_tpu.Model(BIG_DIR)


@pytest.fixture(scope="module")
def corpus(lang):
    rng = np.random.default_rng(6160)
    names = [lang.words.name(i) for i in range(1, len(lang.words))]
    utts = []
    for i in range(N_UTTS):
        ws = [names[rng.integers(0, len(names))]
              for _ in range(WORDS_PER_UTT)]
        srng = np.random.default_rng(7000 + i)
        wav, _ = toydata.synth_utterance_lang(lang, ws, srng)
        utts.append((ws, wav))
    return utts


def _dec(native, **kw):
    return BatchViterbi(
        native.graph,
        DecodeParams(
            beam=native.config.beam,
            max_active=native.config.max_active,
            lattice_beam=native.config.lattice_beam,
            acoustic_scale=native.config.acoustic_scale,
        ),
        silence_pdfs=native.silence_pdfs,
        lattice_records=True,
        **kw,
    )


def _loglikes(native, wav):
    ex = native.feature_extractor()
    am = native.make_am()
    feats = np.asarray(ex.extract(wav[None]))
    return np.asarray(am.forward_utterance(am.params, feats))


def _words(native, dec, recs, frontier):
    _, ols, _ = dec.traceback([recs], frontier, 0)
    return [native.words.name(o) for o in ols]


def test_graph_scale(model, lang):
    """The generated language must actually be at the promised scale."""
    g = model._model.graph
    assert len(lang.words) - 1 >= 600
    assert g.num_states >= 2000, g.num_states
    # homophones present: at least one duplicated pronunciation
    prons = [tuple(p) for p in lang.word_phones.values()]
    assert len(prons) - len(set(prons)) >= 20


def test_bigvocab_v3_vs_v4_parity_and_wer(model, corpus):
    native = model._model
    decs = {
        "v3": _dec(native, frame_step="v3", layout="padded"),
        "v4r": _dec(native, frame_step="auto", pack="packed16",
                    optimize_graph=True, ragged=True),
    }
    refs, hyps = [], {k: [] for k in decs}
    for ws, wav in corpus:
        refs.append(ws)
        ll = _loglikes(native, wav)
        for k, dec in decs.items():
            fr, recs, _, _ = dec.decode_chunk(dec.init_frontier(1), ll)
            hyps[k].append(_words(native, dec, recs, fr))
    # production step word-identical to the oracle at 600-word scale
    assert score_corpus(hyps["v3"], hyps["v4r"]).errors == 0, (
        hyps["v3"], hyps["v4r"])
    base = score_corpus(refs, hyps["v3"])
    # homophones are genuinely ambiguous (LM-separated only), so perfect
    # WER is not expected; the model must still clearly decode
    assert base.wer <= 0.25, base.as_dict()


def test_bigvocab_ladder_vs_fixed(model, corpus):
    """Adaptive max-active ladder vs fixed-K at 600-word scale: the delta
    documented and bounded.  The ladder can transiently decode a segment
    at a tighter max_active; at this scale beam dynamics are real, so a
    small delta is tolerated (recorded) rather than zero-asserted."""
    from vosk_tpu.runtime.pipeline import FusedPipeline

    native = model._model
    pipe = FusedPipeline(native, batch=1, collect_records=True,
                        lattice_records=True)
    pipe.adaptive_ladder = (64, 128, 256)
    S = pipe.chunk_samples

    FILL = {"pm": -1, "state": None, "f_cost": np.inf, "lat_pm": -1,
            "lat_cost": np.inf, "prev": -1, "olabel": 0, "pdf": -1,
            "f_state": None, "lat_ns": None, "lat_prev": -1, "lat_arc": -1}

    def merge_chunks(recs):
        """Stacked pipeline records -> per-utterance record dict.
        v4 schema ({pm, ...}): [chunks, T, B, K] -> [frames, B, K];
        v3 schema ({prev, ...}): [chunks, B, T, L, K] -> [B, frames, L, K]."""
        if "pm" in recs:
            return {
                k: np.asarray(v).reshape((-1,) + np.asarray(v).shape[2:])
                for k, v in recs.items()
            }
        return {
            k: np.concatenate(np.asarray(v), axis=1) for k, v in recs.items()
        }

    def pad_k(r, K, S_sent):
        out = {}
        for key, v in r.items():
            v = np.asarray(v)
            w = K - v.shape[-1]
            if w > 0:
                fill = FILL[key]
                if fill is None:
                    fill = S_sent
                v = np.concatenate(
                    [v, np.full(v.shape[:-1] + (w,), fill, v.dtype)],
                    axis=-1)
            out[key] = v
        return out

    def decode(wav, adaptive):
        n = ((len(wav) + S - 1) // S) * S
        wavp = np.zeros(n, np.float32)
        wavp[: len(wav)] = wav
        audio = wavp.reshape(-1, 1, S)
        st = pipe.init_state()
        if adaptive:
            st, recs_l, _ = pipe.run_adaptive(st, audio, seg=4)
            K = pipe.dec.K
            Ssent = pipe.dec.S
            keep = ("pm", "state") if "pm" in recs_l[0] else (
                "prev", "olabel", "pdf")
            merged = [
                pad_k(merge_chunks({k: r[k] for k in keep}), K, Ssent)
                for r in recs_l if r is not None
            ]
            frame_axis = 0 if "pm" in merged[0] else 1
            rec = {k: np.concatenate([m[k] for m in merged], axis=frame_axis)
                   for k in merged[0]}
            st["frontier"] = pipe.dec.resize_frontier(st["frontier"], K)
        else:
            st, recs, _ = pipe.run_scan(st, audio)
            rec = merge_chunks(recs)
        fr = {k: np.asarray(v) for k, v in st["frontier"].items()}
        _, ols, _ = pipe.dec.traceback([rec], fr, 0)
        return [native.words.name(o) for o in ols]

    refs, fixed_h, adapt_h = [], [], []
    for ws, wav in corpus[:6]:
        refs.append(ws)
        fixed_h.append(decode(wav, adaptive=False))
        adapt_h.append(decode(wav, adaptive=True))
    fixed_wer = score_corpus(refs, fixed_h)
    delta = score_corpus(fixed_h, adapt_h)
    # documented bound: ladder-vs-fixed disagreement at 600-word scale
    assert delta.wer <= 0.10, (delta.as_dict(), fixed_h, adapt_h)
    assert fixed_wer.wer <= 0.25, fixed_wer.as_dict()
