"""Demo app: a Gradio UI and YouTube ingestion over the port's
transcription (the JAX package's `app.py`): upload audio or paste a
YouTube URL → a MIDI file to download.

    python -m yourmt3_tpu_torch.app -ckpt runs/exp/last [--port 7860] [--cpu]

gradio and yt-dlp are optional: the module imports without them and says
which is missing when it is needed. The model runs on the CUDA device
unless the caller asks for the CPU.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
from typing import List, Optional

from .api import ModelBundle, init_model, load_checkpoint, transcribe


def fetch_youtube_audio(url: str, out_dir: str) -> str:
    """YouTube URL → wav path (needs yt-dlp, ffmpeg and the network)."""
    try:
        import yt_dlp
    except ImportError as e:
        raise RuntimeError(
            "YouTube ingestion requires yt-dlp (network environment)") from e
    opts = {
        "format": "bestaudio/best",
        "outtmpl": os.path.join(out_dir, "audio.%(ext)s"),
        "postprocessors": [{"key": "FFmpegExtractAudio",
                            "preferredcodec": "wav"}],
        "quiet": True,
    }
    with yt_dlp.YoutubeDL(opts) as ydl:
        ydl.download([url])
    return os.path.join(out_dir, "audio.wav")


def build_demo(bundle: Optional[ModelBundle] = None,
               checkpoint: Optional[str] = None, device=None):
    """→ a gradio.Interface (call .launch() to serve). Without `bundle`
    the model comes from `checkpoint`, else a random t5_small, on
    `device` (default: CUDA)."""
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError("the demo UI requires gradio; use "
                           "`python -m yourmt3_tpu_torch.cli.transcribe` "
                           "instead") from e
    if bundle is None:
        bundle = (load_checkpoint(checkpoint, device=device) if checkpoint
                  else init_model("t5_small", "mt3_full_plus", device=device))

    def run(audio_file, youtube_url):
        with tempfile.TemporaryDirectory() as td:
            if youtube_url:
                audio_file = fetch_youtube_audio(youtube_url, td)
            if not audio_file:
                raise ValueError("provide an audio file or a YouTube URL")
            out = os.path.join(td, "transcription.mid")
            transcribe(bundle, audio_file, out)
            # out of the temporary directory, so that gradio can serve it
            final = os.path.join(tempfile.gettempdir(), os.path.basename(out))
            shutil.copyfile(out, final)
            return final

    return gr.Interface(
        fn=run,
        inputs=[gr.Audio(type="filepath", label="Audio file"),
                gr.Textbox(label="…or YouTube URL")],
        outputs=gr.File(label="MIDI transcription"),
        title="YourMT3: multi-task multi-track music transcription",
    )


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description="Serve the transcription demo")
    p.add_argument("-ckpt", "--checkpoint", default=None)
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA device")
    args = p.parse_args(argv)
    build_demo(checkpoint=args.checkpoint,
               device="cpu" if args.cpu else None).launch(server_port=args.port)


if __name__ == "__main__":
    main()
