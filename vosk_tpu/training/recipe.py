"""In-process training recipe — the in-framework equivalent of the
reference's Kaldi bash pipeline (training/run.sh stages 0-5: data prep ->
AM training -> graph build -> decode/score).

The reference recipe shells out to Kaldi binaries over files; here every
stage is a Python call over the framework's own components, so the whole
pipeline is jit-compiled and runs on the accelerator:

  stage 0  data prep: features + per-frame alignments
           (run.sh:10-30 data/lang prep; alignments here come from the
           synthesis oracle or a provided alignment function — GMM
           bootstrap alignment is out of scope, documented)
  stage 1  AM training: frame-CE or LF-MMI chain objective
           (run.sh stage 4, local/chain/run_tdnn.sh:135-166)
  stage 2  language model estimation from the training transcripts
           (LanguageModelEstimator — runtime grammar machinery reused)
  stage 3  graph build: HCLG-equivalent decoding graph
           (run.sh:80 utils/mkgraph analogue, graph/builder.py)
  stage 4  model-dir export (io/native.py; loadable by Model())
  stage 5  decode the held-out set + WER (local/score.sh analogue,
           utils/wer.py)

Demo invocation (synthetic corpus):  python -m vosk_tpu.training.recipe
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class RecipeConfig:
    out_dir: str
    objective: str = "chain"      # "ce" | "chain"
    train_steps: int = 400
    hidden: int = 64
    bottleneck: int = 16
    subsample: int = 3
    beam: float = 16.0
    max_active: int = 2000
    seed: int = 0


def run_recipe(
    cfg: RecipeConfig,
    train_utts: Sequence[Tuple[List[str], np.ndarray, np.ndarray]],
    dev_utts: Sequence[Tuple[List[str], np.ndarray]],
    lexicon,
    words,
    phones,
    extractor,
    sil_phone: int,
    log: Callable[[str], None] = print,
) -> Dict:
    """train_utts: [(words, wav [N], phone_alignment [N])];
    dev_utts: [(words, wav)].  Returns the WER report dict (stage 5)."""
    import dataclasses as dc

    import vosk_tpu
    from ..graph.builder import Topology, build_decoding_graph
    from ..graph.lm import LanguageModelEstimator, LanguageModelOptions
    from ..io import native
    from ..models.tdnnf import TdnnfConfig
    from ..models.train import train_frame_ce
    from ..models.chain import train_chain
    from ..utils.wer import score_corpus

    # ---- stage 0: features + frame alignments.  Utterances may come with
    # phone alignments (synthesis oracle / forced-align) or with
    # phn=None — then the flat-start GMM bootstrap produces them from the
    # transcripts alone (reference run.sh:31-60 mono GMM stages).
    ss = cfg.subsample
    if any(phn is None for _, _, phn in train_utts):
        log("stage 0a: flat-start GMM bootstrap alignment (run.sh:31-60)")
        from .gmm import flat_start_align

        boot = flat_start_align(
            [wav for _, wav, _ in train_utts],
            [[words.find(w) for w in ws] for ws, _, _ in train_utts],
            lexicon.prons,
            num_phones=len(phones),
            sil_phone=sil_phone,
            extractor=extractor,
            log=log,
        )
        train_utts = [
            (ws, wav, phn if phn is not None else boot[i])
            for i, (ws, wav, phn) in enumerate(train_utts)
        ]
    log("stage 0: data prep (features + alignments)")
    utt_feats, utt_labels = [], []
    for ws, wav, phn in train_utts:
        feats = np.asarray(extractor.extract(wav[None]))[0]
        fo = extractor.frame_opts
        n_out = -(-feats.shape[0] // ss)
        centers = (np.arange(n_out) * ss) * fo.window_shift + fo.window_size // 2
        labels = phn[np.clip(centers, 0, len(phn) - 1)] - 1  # pdf = phone-1
        utt_feats.append(feats)
        utt_labels.append(labels)
    Tmax = max(f.shape[0] for f in utt_feats)
    Omax = -(-Tmax // ss)
    fpad = np.zeros((len(utt_feats), Tmax, utt_feats[0].shape[1]), np.float32)
    lpad = np.zeros((len(utt_feats), Omax), np.int64)
    for i, (f, l) in enumerate(zip(utt_feats, utt_labels)):
        fpad[i, : f.shape[0]] = f
        fpad[i, f.shape[0]:] = f[-1]
        lpad[i, : len(l)] = l
        lpad[i, len(l):] = l[-1]

    # ---- stage 1: AM training
    log(f"stage 1: AM training ({cfg.objective}, {cfg.train_steps} steps)")
    am_cfg = TdnnfConfig(
        feat_dim=fpad.shape[2],
        hidden_dim=cfg.hidden,
        bottleneck_dim=cfg.bottleneck,
        prefinal_dim=32,
        num_pdfs=len(phones),
        time_strides=(1, 1, ss),
        subsample=ss,
    )
    if cfg.objective == "chain":
        params = train_chain(am_cfg, fpad, lpad, steps=cfg.train_steps,
                             seed=cfg.seed)
    else:
        params = train_frame_ce(am_cfg, fpad, lpad, steps=cfg.train_steps,
                                seed=cfg.seed)

    # ---- stage 2: word LM from the transcripts
    log("stage 2: language model estimation")
    est = LanguageModelEstimator(LanguageModelOptions(2, 0.5))
    for ws, _, _ in train_utts:
        est.add_counts([words.find(w) for w in ws])
    g = est.estimate()

    # ---- stage 3: decoding graph
    log("stage 3: graph build")
    topo = Topology(states_per_phone=1, self_loop_prob=0.7)
    graph, info = build_decoding_graph(lexicon, g, topo)

    # ---- stage 4: export
    log(f"stage 4: export -> {cfg.out_dir}")
    mc = native.ModelConfig(
        sample_rate=extractor.frame_opts.samp_freq,
        beam=cfg.beam,
        max_active=cfg.max_active,
        acoustic_scale=1.0,
        am=dc.asdict(am_cfg),
        feature_type="mfcc",
        frame_opts={"dither": 1.0},
        mel_opts={"num_bins": extractor.opts.mel_opts.num_bins,
                  "low_freq": extractor.opts.mel_opts.low_freq,
                  "high_freq": extractor.opts.mel_opts.high_freq},
        mfcc_opts={"num_ceps": extractor.opts.num_ceps,
                   "use_energy": False},
    )
    native.save_model(
        cfg.out_dir, mc, params, graph, words, phones, lexicon,
        info["phone_of_pdf"], info["silence_pdfs"], topo, g_fst=g,
    )

    # ---- stage 5: decode dev + WER
    log("stage 5: decode + score")
    model = vosk_tpu.Model(cfg.out_dir)
    refs, hyps = [], []
    for ws, wav in dev_utts:
        rec = vosk_tpu.KaldiRecognizer(
            model, extractor.frame_opts.samp_freq)
        rec.AcceptWaveform(np.clip(wav, -32768, 32767).astype("<i2"))
        hyps.append(json.loads(rec.FinalResult())["text"].split())
        refs.append(list(ws))
    rep = score_corpus(refs, hyps).as_dict()
    log(f"WER report: {rep}")
    with open(os.path.join(cfg.out_dir, "RESULTS.json"), "w") as f:
        json.dump(rep, f)
    return rep


def demo(out_dir: str = "/tmp/vosk_tpu_recipe_demo",
         objective: str = "chain") -> Dict:
    """Synthetic-corpus demo run (the mini-LibriSpeech stand-in)."""
    from ..utils import toydata

    rng = np.random.default_rng(0)
    words, phones = toydata.build_symbols()
    ex = toydata.make_extractor()
    train, dev = [], []
    for i in range(24):
        ws = [toydata.WORDS[rng.integers(0, len(toydata.WORDS))]
              for _ in range(5)]
        wav, phn = toydata.synth_utterance(ws, rng)
        train.append((ws, wav, phn))
    for i in range(6):
        ws = [toydata.WORDS[rng.integers(0, len(toydata.WORDS))]
              for _ in range(4)]
        wav, _ = toydata.synth_utterance(ws, rng)
        dev.append((ws, wav))
    from ..graph.builder import Lexicon

    lex = Lexicon(
        words=words,
        phones=phones,
        prons={words.find(w): [list(p)]
               for w, p in toydata.WORD_PHONES.items()},
        silence_phone=toydata.SIL_PHONE,
        silence_cost=0.7,
    )
    return run_recipe(
        RecipeConfig(out_dir=out_dir, objective=objective),
        train, dev, lex, words, phones, ex, toydata.SIL_PHONE,
    )


if __name__ == "__main__":
    import sys

    demo(*(sys.argv[1:] or []))
