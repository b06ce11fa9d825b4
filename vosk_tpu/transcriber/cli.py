"""`vosk-transcriber` CLI — argument parity with the reference
(python/vosk/transcriber/cli.py): -i/-o files or directories, --model/
--model-name/--lang model selection, --server websocket mode, --tasks
parallelism, --output-type txt|srt|webvtt, --log-level.
"""
from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

parser = argparse.ArgumentParser(
    description="Transcribe audio file and save result in selected format"
)
parser.add_argument("--model", "-m", type=str, help="model path")
parser.add_argument(
    "--server",
    "-s",
    const="ws://localhost:2700",
    nargs="?",
    default=None,
    help="use server for recognition (optionally pass ws:// url)",
)
parser.add_argument("--list-models", default=False, action="store_true")
parser.add_argument("--list-languages", default=False, action="store_true")
parser.add_argument("--model-name", "-n", type=str, help="select model by name")
parser.add_argument("--lang", "-l", default=None, type=str, help="select model by language")
parser.add_argument("--input", "-i", type=str, help="audiofile")
parser.add_argument("--output", "-o", default="", type=str, help="optional output file")
parser.add_argument("--output-type", "-t", default="txt", type=str, help="txt, srt or webvtt")
parser.add_argument("--tasks", "-ts", default=10, type=int, help="parallel tasks")
parser.add_argument("--log-level", default="INFO", help="logging level")


def main() -> None:
    from ..utils import compile_cache

    args = parser.parse_args()
    logging.getLogger().setLevel(args.log_level.upper())
    compile_cache.enable()

    if args.list_models:
        import vosk_tpu

        vosk_tpu.list_models()
        return
    if args.list_languages:
        import vosk_tpu

        vosk_tpu.list_languages()
        return

    if not args.input:
        logging.info("Please specify input file or directory")
        sys.exit(1)
    if not Path(args.input).exists():
        logging.info(
            "File/folder '%s' does not exist, please specify an existing file/directory",
            args.input,
        )
        sys.exit(1)

    from .transcriber import Transcriber

    transcriber = Transcriber(args)

    if Path(args.input).is_dir():
        task_list = []
        out_dir = Path(args.output) if args.output else None
        for f in sorted(Path(args.input).iterdir()):
            if not f.is_file():
                continue
            if out_dir is not None:
                out_dir.mkdir(parents=True, exist_ok=True)
                task_list.append((str(f), str(out_dir / (f.stem + "." + args.output_type))))
            else:
                task_list.append((str(f), ""))
    else:
        task_list = [(args.input, args.output)]

    transcriber.process_task_list(task_list)


if __name__ == "__main__":
    main()
