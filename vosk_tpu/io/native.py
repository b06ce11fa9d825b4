"""Native vosk_tpu model-directory format.

Mirrors the *role* of the reference's model dir (layout probing at
src/model.cc:106-128, V2 layout at model.cc:180-207) with a native
serialization: JSON config + npz arrays.

    model_dir/
      vosk_tpu_model.json   master config (feature/am/decode/endpoint)
      am.npz                acoustic-model parameters
      graph.npz             flattened DecodingGraph arrays + pdf maps
      words.txt             word symbol table (OpenFST text format)
      phones.txt            phone symbol table
      lexicon.txt           "word phone1 phone2 ..." (runtime grammar support)

Kaldi-layout model directories are handled separately by io/kaldi (reader
side), converging on the same in-memory `NativeModel`.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..graph.builder import Lexicon, Topology
from ..graph.fst import DecodingGraph, SymbolTable
from ..models.tdnnf import TdnnfConfig
from ..ops import features as F

FORMAT_VERSION = 1
CONFIG_NAME = "vosk_tpu_model.json"


@dataclasses.dataclass
class EndpointRule:
    must_contain_nonsilence: bool
    min_trailing_silence: float
    max_relative_cost: float
    min_utterance_length: float = 0.0


def default_endpoint_rules() -> List[EndpointRule]:
    """Kaldi OnlineEndpointConfig defaults with the reference's overrides
    (src/model.cc:142-145)."""
    inf = float("inf")
    return [
        EndpointRule(False, 5.0, inf),
        EndpointRule(True, 0.5, 2.0),
        EndpointRule(True, 1.0, 8.0),
        EndpointRule(True, 2.0, inf),
        EndpointRule(False, 0.0, inf, 20.0),
    ]


@dataclasses.dataclass
class ModelConfig:
    sample_rate: float = 16000.0
    feature_type: str = "mfcc"  # mfcc | fbank
    frame_opts: dict = dataclasses.field(default_factory=dict)
    mel_opts: dict = dataclasses.field(default_factory=dict)
    mfcc_opts: dict = dataclasses.field(default_factory=dict)
    am: dict = dataclasses.field(default_factory=dict)
    # online pitch appended to the base features when set (3 dims; the
    # reference reads conf/pitch.conf, src/model.cc:265-276)
    pitch_opts: Optional[dict] = None
    beam: float = 13.0
    max_active: int = 7000
    lattice_beam: float = 6.0
    acoustic_scale: float = 1.0
    endpoint_rules: Optional[list] = None
    frame_shift_seconds: float = 0.03  # output-frame shift (0.01 * subsample)


class NativeModel:
    """Loaded model: everything Recognizer/BatchRecognizer needs."""

    def __init__(
        self,
        config: ModelConfig,
        am_params: Dict[str, np.ndarray],
        graph: Optional[DecodingGraph],
        words: SymbolTable,
        phones: SymbolTable,
        lexicon: Optional[Lexicon],
        phone_of_pdf: np.ndarray,
        silence_pdfs: np.ndarray,
        topology: Topology,
        am_override=None,
    ):
        self.config = config
        self.am_override = am_override
        self.am_config = TdnnfConfig(**config.am) if config.am else None
        self.am_params = am_params
        self.g_fst = None       # word-level LM in the graph (for rescoring subtract)
        self.rescore_lm = None  # big ARPA LM (for rescoring add)
        self.rnnlm = None       # neural LM (mixed 0.5/0.5 with the ARPA)
        self.word_boundary = None  # phone -> position map (word alignment)
        self.global_cmvn_stats = None
        self.ivector = None     # IvectorDirConfig (reference model.cc:247-263)
        self.silence_weight = 1.0   # ivector silence weighting (1.0 = off)
        self.silence_weight_phones: set = set()
        self.graph = graph
        self.words = words
        self.phones = phones
        self.lexicon = lexicon
        self.phone_of_pdf = phone_of_pdf
        self.silence_pdfs = silence_pdfs
        self.topology = topology
        import threading

        self._decoder_cache: dict = {}
        self._decoder_lock = threading.Lock()

    def shared_decoder(self, graph=None, cache_key=None, **kw):
        """A BatchViterbi over this model's graph, shared across
        recognizers — the reference's core architectural property (one
        immutable Model, N cheap Recognizers; model.cc:343-354).  Building
        a decoder runs the load-time graph transform and owns a jit cache,
        so per-recognizer construction was seconds of redundant work.

        graph/cache_key: runtime-grammar recognizers pass their recomposed
        graph with a grammar-string key; the main graph uses key None.
        """
        from ..ops.viterbi import BatchViterbi, DecodeParams

        key = (
            cache_key,
            self.config.beam, self.config.max_active,
            self.config.lattice_beam, self.config.acoustic_scale,
            tuple(sorted(kw.items())),
        )
        with self._decoder_lock:
            dec = self._decoder_cache.get(key)
            if dec is None:
                dec = BatchViterbi(
                    graph if graph is not None else self.graph,
                    DecodeParams(
                        beam=self.config.beam,
                        max_active=self.config.max_active,
                        lattice_beam=self.config.lattice_beam,
                        acoustic_scale=self.config.acoustic_scale,
                    ),
                    lattice_records=True,
                    silence_pdfs=self.silence_pdfs,
                    frame_step="auto",
                    pack="packed16",
                    optimize_graph=True,
                    **kw,
                )
                self._decoder_cache[key] = dec
        return dec

    def make_am(self):
        """Instantiate the streaming acoustic model (native TDNN-F weights or
        a loaded nnet3 network)."""
        if self.am_override is not None:
            return self.am_override
        from ..models.tdnnf import TdnnfModel

        return TdnnfModel(self.am_config, self.am_params)

    def make_ivector_extractor(self, chunk_frames: int = 32):
        """Online i-vector extractor when the model ships an ivector/ dir
        (reference model.cc:247-263); None otherwise."""
        if self.ivector is None:
            return None
        from ..ops.ivector import OnlineIvectorExtractor

        return OnlineIvectorExtractor(self.ivector, chunk_frames=chunk_frames)

    def feature_extractor(self) -> F.FeatureExtractor:
        fo = F.FrameOptions(samp_freq=self.config.sample_rate, **self.config.frame_opts)
        mel = F.MelOptions(**self.config.mel_opts)
        if self.config.feature_type == "mfcc":
            opts = F.MfccOptions(frame_opts=fo, mel_opts=mel, **self.config.mfcc_opts)
        else:
            opts = F.FbankOptions(frame_opts=fo, mel_opts=mel)
        return F.FeatureExtractor(opts, pitch_opts=self.config.pitch_opts)

    def endpoint_rules(self) -> List[EndpointRule]:
        if self.config.endpoint_rules is None:
            return default_endpoint_rules()
        return [EndpointRule(**r) for r in self.config.endpoint_rules]

    def find_word(self, word: str) -> int:
        """vosk_model_find_word parity (vosk_api.h:69-74)."""
        return self.words.find(word)


def _graph_to_npz(graph: DecodingGraph) -> dict:
    d = dataclasses.asdict(graph)
    d["start"] = np.int32(d["start"])
    d["num_states"] = np.int32(d["num_states"])
    d["eps_depth"] = np.int32(d["eps_depth"])
    d["max_em_out"] = np.int32(d["max_em_out"])
    d["max_eps_out"] = np.int32(d["max_eps_out"])
    return d


def _graph_from_npz(z) -> DecodingGraph:
    return DecodingGraph(
        num_states=int(z["num_states"]),
        start=int(z["start"]),
        em_off=z["em_off"],
        em_pdf=z["em_pdf"],
        em_olabel=z["em_olabel"],
        em_w=z["em_w"],
        em_next=z["em_next"],
        eps_off=z["eps_off"],
        eps_olabel=z["eps_olabel"],
        eps_w=z["eps_w"],
        eps_next=z["eps_next"],
        final_cost=z["final_cost"],
        eps_depth=int(z["eps_depth"]),
        max_em_out=int(z["max_em_out"]),
        max_eps_out=int(z["max_eps_out"]),
    )


def _save_std_fst(path, fst) -> None:
    """Store a word-level StdFst (e.g. the graph LM G used for rescoring
    subtraction, role of rescore/G.fst at reference model.cc:310-311)."""
    rows = []
    for s in range(fst.num_states):
        for il, ol, w, ns in fst.arcs[s]:
            rows.append((s, il, ol, w, ns))
    arr = np.asarray(rows, np.float64).reshape(-1, 5)
    np.savez(
        path,
        arcs=arr,
        finals=np.asarray(fst.final, np.float32),
        start=np.int32(fst.start),
    )


def _load_std_fst(path):
    from ..graph.fst import StdFst

    z = np.load(path)
    f = StdFst()
    f.add_states(len(z["finals"]))
    f.set_start(int(z["start"]))
    for s, fw in enumerate(z["finals"]):
        if np.isfinite(fw):
            f.set_final(s, float(fw))
    for s, il, ol, w, ns in z["arcs"]:
        f.add_arc(int(s), int(il), int(ol), float(w), int(ns))
    return f


def save_model(
    path,
    config: ModelConfig,
    am_params: Dict[str, np.ndarray],
    graph: Optional[DecodingGraph],
    words: SymbolTable,
    phones: SymbolTable,
    lexicon: Optional[Lexicon],
    phone_of_pdf,
    silence_pdfs,
    topology: Topology = Topology(),
    g_fst=None,
) -> None:
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    cfg = dataclasses.asdict(config)
    cfg["format"] = FORMAT_VERSION
    cfg["topology"] = dataclasses.asdict(topology)
    if lexicon is not None:
        cfg["silence_phone"] = lexicon.silence_phone
        cfg["silence_cost"] = lexicon.silence_cost
    (p / CONFIG_NAME).write_text(json.dumps(cfg, indent=2, default=float))
    np.savez(p / "am.npz", **am_params)
    if graph is not None:
        np.savez(p / "graph.npz", **_graph_to_npz(graph))
    if g_fst is not None:
        _save_std_fst(p / "g.npz", g_fst)
    np.savez(
        p / "maps.npz",
        phone_of_pdf=np.asarray(phone_of_pdf, np.int32),
        silence_pdfs=np.asarray(silence_pdfs, np.int32),
    )
    words.write_text(p / "words.txt")
    phones.write_text(p / "phones.txt")
    if lexicon is not None:
        with open(p / "lexicon.txt", "w", encoding="utf-8") as f:
            for wid, prons in lexicon.prons.items():
                for pron in prons:
                    syms = " ".join(lexicon.phones.name(ph) for ph in pron)
                    f.write(f"{lexicon.words.name(wid)} {syms}\n")


def load_any(path) -> NativeModel:
    """Load a model dir of any supported layout: native vosk_tpu format or
    Kaldi V1/V2 layouts (reference model.cc:106-128 probing)."""
    p = Path(path)
    if (p / CONFIG_NAME).exists():
        return load_model(path)
    from .kaldi_loader import is_kaldi_model_dir, load_kaldi_model

    if is_kaldi_model_dir(path):
        return load_kaldi_model(path)
    return load_model(path)  # raises the standard error message


def load_model(path) -> NativeModel:
    p = Path(path)
    cfg_path = p / CONFIG_NAME
    if not cfg_path.exists():
        raise FileNotFoundError(
            f"Folder '{path}' does not contain model files. Make sure you "
            "specified the model path properly."
        )
    raw = json.loads(cfg_path.read_text())
    raw.pop("format", None)
    topo = Topology(**raw.pop("topology", {}))
    sil_phone = raw.pop("silence_phone", 0)
    sil_cost = raw.pop("silence_cost", 0.7)
    config = ModelConfig(**{k: v for k, v in raw.items() if k in {f.name for f in dataclasses.fields(ModelConfig)}})
    if config.endpoint_rules is not None:
        config.endpoint_rules = [
            {**r, "max_relative_cost": float(r["max_relative_cost"])}
            for r in config.endpoint_rules
        ]
    am_params = dict(np.load(p / "am.npz"))
    graph = None
    if (p / "graph.npz").exists():
        graph = _graph_from_npz(np.load(p / "graph.npz"))
    maps = np.load(p / "maps.npz")
    words = SymbolTable.read_text(p / "words.txt")
    phones = SymbolTable.read_text(p / "phones.txt")
    lexicon = None
    if (p / "lexicon.txt").exists():
        prons: Dict[int, List[List[int]]] = {}
        with open(p / "lexicon.txt", "r", encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    continue
                wid = words.find(parts[0])
                pron = [phones.find(s) for s in parts[1:]]
                if wid > 0 and all(ph > 0 for ph in pron):
                    prons.setdefault(wid, []).append(pron)
        lexicon = Lexicon(
            words=words,
            phones=phones,
            prons=prons,
            silence_phone=sil_phone,
            silence_cost=sil_cost,
        )
    model = NativeModel(
        config=config,
        am_params=am_params,
        graph=graph,
        words=words,
        phones=phones,
        lexicon=lexicon,
        phone_of_pdf=maps["phone_of_pdf"],
        silence_pdfs=maps["silence_pdfs"],
        topology=topo,
    )
    # rescoring resources (reference loads rescore/G.fst + G.carpa,
    # model.cc:308-314): graph LM to subtract + ARPA LM to add
    if (p / "g.npz").exists():
        model.g_fst = _load_std_fst(p / "g.npz")
    if (p / "rescore.arpa").exists():
        from ..graph.arpa import BackoffLm

        model.rescore_lm = BackoffLm.read_arpa(p / "rescore.arpa", words)
    if (p / "rnnlm" / "vosk_tpu_rnnlm.json").exists():
        from ..models.rnnlm import RnnlmModel

        model.rnnlm = RnnlmModel.load(p / "rnnlm")
    return model
