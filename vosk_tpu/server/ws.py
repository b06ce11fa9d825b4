"""Websocket ASR server speaking the vosk-server protocol.

Protocol (client side visible at reference
python/vosk/transcriber/transcriber.py:51-72):
  client -> '{"config": {"sample_rate": 16000, ...}}'     (optional, first)
  client -> binary PCM16 chunks; server replies per chunk with either
            {"partial": ...} or, after an endpoint, a full result
  client -> '{"eof": 1}' -> server replies with the final result.

Config options honored: sample_rate, words, max_alternatives, phrase_list
(same knobs the vosk-server exposes).

Run: python -m vosk_tpu.server.ws --model <dir> [--port 2700]
"""
from __future__ import annotations

import argparse
import asyncio
import json
import logging

from . import wsproto


class ASRServer:
    def __init__(self, model, sample_rate: float = 16000.0):
        self.model = model
        self.default_rate = sample_rate

    async def handle(self, ws: wsproto.WebSocket) -> None:
        import vosk_tpu

        rec = None
        rate = self.default_rate
        words = False
        max_alts = 0
        phrase_list = None

        def make_rec():
            if phrase_list:
                r = vosk_tpu.KaldiRecognizer(self.model, rate, json.dumps(phrase_list))
            else:
                r = vosk_tpu.KaldiRecognizer(self.model, rate)
            r.SetWords(words)
            if max_alts:
                r.SetMaxAlternatives(max_alts)
            return r

        loop = asyncio.get_running_loop()
        while True:
            try:
                msg = await ws.recv()
            except wsproto.ConnectionClosed:
                break
            if isinstance(msg, str):
                try:
                    obj = json.loads(msg)
                except json.JSONDecodeError:
                    obj = {}
                if "config" in obj:
                    cfg = obj["config"]
                    rate = float(cfg.get("sample_rate", rate))
                    words = bool(cfg.get("words", words))
                    max_alts = int(cfg.get("max_alternatives", max_alts))
                    phrase_list = cfg.get("phrase_list", phrase_list)
                    rec = None
                    continue
                if obj.get("eof"):
                    if rec is None:
                        rec = make_rec()
                    final = await loop.run_in_executor(None, rec.FinalResult)
                    await ws.send(final)
                    break
                continue
            # binary audio
            if rec is None:
                rec = make_rec()
            endpoint = await loop.run_in_executor(None, rec.AcceptWaveform, msg)
            if endpoint:
                await ws.send(await loop.run_in_executor(None, rec.Result))
            else:
                await ws.send(await loop.run_in_executor(None, rec.PartialResult))


async def amain(args) -> None:
    import vosk_tpu

    model = vosk_tpu.Model(
        model_path=args.model, model_name=args.model_name, lang=args.lang
    )
    srv = ASRServer(model)
    server = await wsproto.serve(srv.handle, args.interface, args.port)
    logging.info("Listening on ws://%s:%d", args.interface, args.port)
    async with server:
        await server.serve_forever()


def main() -> None:
    p = argparse.ArgumentParser(description="vosk_tpu websocket server")
    p.add_argument("--model", "-m", type=str)
    p.add_argument("--model-name", "-n", type=str)
    p.add_argument("--lang", "-l", type=str, default=None)
    p.add_argument("--interface", default="0.0.0.0")
    p.add_argument("--port", type=int, default=2700)
    p.add_argument("--log-level", default="INFO")
    args = p.parse_args()
    logging.getLogger().setLevel(args.log_level.upper())
    from ..utils import compile_cache

    compile_cache.enable()
    asyncio.run(amain(args))


if __name__ == "__main__":
    main()
