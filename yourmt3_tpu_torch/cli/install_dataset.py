"""Dataset installation CLI: download + convert each dataset into the
index files that the port's data loaders read (data/indexes.py).

    python -m yourmt3_tpu_torch.cli.install_dataset maestro --source /data/maestro-v3.0.0
    python -m yourmt3_tpu_torch.cli.install_dataset guitarset --download

Capability parity target: reference `install_dataset.py` (SURVEY.md C16,
§3.4).
`--url` (or the per-dataset default in DOWNLOAD_URLS) fetches + extracts
via data/download.py (resumable, checksummed) and then converts; with an
already-downloaded tree pass `--source` to skip the fetch.
"""

from __future__ import annotations

import argparse
import os

# direct archive URLs where the dataset publishes one; landing pages
# (auth/gdrive-gated sets) remain documented as hints
DOWNLOAD_URLS = {
    "slakh": "https://zenodo.org/record/4599666/files/slakh2100_flac_redux.tar.gz",
    "guitarset": "https://zenodo.org/record/3371780/files/audio_mono-mic.zip",
    "egmd": "https://storage.googleapis.com/magentadata/datasets/e-gmd/v1.0.0/e-gmd-v1.0.0.zip",
    "maestro": "https://storage.googleapis.com/magentadata/datasets/maestro/v3.0.0/maestro-v3.0.0.zip",
}

DOWNLOAD_HINTS = {
    "maestro": "https://magenta.tensorflow.org/datasets/maestro (v3.0.0)",
    "slakh": "https://zenodo.org/record/4599666 (slakh2100_flac_redux; FLAC decoded natively)",
    "guitarset": "https://zenodo.org/record/3371780",
    "enstdrums_dtp": "https://perso.telecom-paristech.fr/grichard/ENST-drums/",
    "enstdrums_dtm": "same as enstdrums_dtp",
    "egmd": "https://magenta.tensorflow.org/datasets/e-gmd",
    "urmp": "https://labsites.rochester.edu/air/projects/URMP.html",
    "mir_st500": "https://github.com/york135/singing_transcription_ICASSP2021",
    "cmedia": "MIREX CMedia singing transcription set",
    "mir1k": "https://sites.google.com/site/unvoicedsoundseparation/mir-1k",
    "rwc_pop": "RWC Popular Music Database (AIST) + aligned MIDI",
    "idmt_smt_bass": "https://www.idmt.fraunhofer.de/en/publications/datasets/bass.html",
    "synth": "generated locally (no download)",
}


def main(argv=None) -> None:
    from ..config.data_presets import data_home
    from ..data.preprocess.converters import CONVERTERS

    p = argparse.ArgumentParser(description="Download/convert a dataset to ymt3 indexes")
    p.add_argument("dataset", choices=sorted(list(CONVERTERS) + ["synth"]))
    p.add_argument("--source", help="path to an already-downloaded dataset root")
    p.add_argument("--download", action="store_true",
                   help="fetch + extract the dataset archive first")
    p.add_argument("--url", default=None,
                   help="override the archive URL (file:// works)")
    p.add_argument("--sha256", default=None, help="archive checksum to verify")
    p.add_argument("--data-home", default=None,
                   help=f"index output root (default $YMT3_DATA_HOME)")
    p.add_argument("--synth-tracks", type=int, default=8)
    args = p.parse_args(argv)
    home = args.data_home or data_home()

    if args.dataset == "synth":
        from ..data.preprocess.synth import build_synth_dataset
        out = build_synth_dataset(home, n_tracks=args.synth_tracks)
        print(out)
        return
    source = args.source
    if source is None and (args.download or args.url):
        url = args.url or DOWNLOAD_URLS.get(args.dataset)
        if not url:
            raise SystemExit(
                f"no direct archive URL for {args.dataset}; download "
                f"manually: {DOWNLOAD_HINTS[args.dataset]}")
        from ..data.download import fetch_and_extract
        work = os.path.join(home, "downloads", args.dataset)
        source = fetch_and_extract(url, work, sha256=args.sha256)
        # archives usually wrap a single top-level dir — descend into it
        entries = os.listdir(source)
        if len(entries) == 1 and os.path.isdir(os.path.join(source, entries[0])):
            source = os.path.join(source, entries[0])
    if not source:
        raise SystemExit(
            f"--source or --download required. URL: "
            f"{DOWNLOAD_HINTS[args.dataset]}")
    out = CONVERTERS[args.dataset](source, home)
    print(out)


if __name__ == "__main__":
    main()
