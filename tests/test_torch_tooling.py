"""The port's dataset tooling, demo and profiling: its converters,
download and install_dataset write the same files as the JAX package's
on local fixtures (file:// URLs only, no network), app.py and
`cli.transcribe --url` run with stand-in gradio and yt_dlp modules, and
profiling.trace writes a trace on the CPU."""

import glob
import json
import os
import sys
import tarfile
import types
import zipfile

import numpy as np
import pytest

from yourmt3_tpu.cli.install_dataset import main as jax_install
from yourmt3_tpu.data import download as jax_download
from yourmt3_tpu.data.preprocess import converters as jax_cv
from yourmt3_tpu_torch import api, app
from yourmt3_tpu_torch.cli import install_dataset
from yourmt3_tpu_torch.cli import transcribe as cli_transcribe
from yourmt3_tpu_torch.data import download
from yourmt3_tpu_torch.data.audio_io import write_wav
from yourmt3_tpu_torch.data.preprocess import converters as cv
from yourmt3_tpu_torch.tokens import Note, midi2note, note_event2midi
from yourmt3_tpu_torch.utils import profiling

from torch_port_util import one_intra_op_thread  # noqa: F401  (decode loops)

PIANO = [Note(False, 0, 0.25, 0.75, 60, 90), Note(False, 0, 0.50, 1.00, 64, 80)]
DRUMS = [Note(True, 128, 0.2, 0.21, 36, 100), Note(True, 128, 0.4, 0.41, 38, 100)]


def _wav(path, seconds=1.0, sr=16000):
    os.makedirs(os.path.dirname(str(path)), exist_ok=True)
    write_wav(str(path), np.zeros(int(sr * seconds), np.float32), sr)


def _midi(path, notes):
    os.makedirs(os.path.dirname(str(path)), exist_ok=True)
    note_event2midi(notes, str(path))


def _json(path, obj):
    os.makedirs(os.path.dirname(str(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def _guitarset(src, name="00_BN1-129-Eb_solo"):
    _json(src / "annotation" / f"{name}.jams", {"annotations": [
        {"namespace": "note_midi",
         "data": [{"time": 0.5, "duration": 0.4, "value": 55.02},
                  {"time": 1.0, "duration": 0.2, "value": 59.9}]}]})
    _wav(src / "audio_mono-mic" / f"{name}_mic.wav")


def _build_sources(root):
    """The fixture trees of tests/test_converters.py, one per converter."""
    src = {}
    s = src["maestro"] = root / "maestro"
    _json(s / "maestro-v3.0.0.json", {
        "split": {"0": "train", "1": "test"},
        "midi_filename": {"0": "2020/a.midi", "1": "2020/b.midi"},
        "audio_filename": {"0": "2020/a.wav", "1": "2020/b.wav"}})
    for n in "ab":
        _midi(s / "2020" / f"{n}.midi", PIANO)
        _wav(s / "2020" / f"{n}.wav")
    s = src["enstdrums_dtp"] = src["enstdrums_dtm"] = root / "enst"
    for drummer in ("drummer_1", "drummer_3"):
        ann = s / drummer / "annotation" / "001_hits.txt"
        os.makedirs(ann.parent)
        ann.write_text("0.50 bd\n0.75 sd\n1.00 chh\n")
        for mix in ("wet_mix", "dry_mix"):
            _wav(s / drummer / "audio" / mix / "001_hits.wav")
    s = root / "urmp" / "01_Jupiter_vn_vc"
    src["urmp"] = root / "urmp"
    _wav(s / "AuMix_01_Jupiter_vn_vc.wav")
    (s / "Notes_1_vn_01.txt").write_text("0.5 440.0 0.4\n1.0 523.25 0.3\n")
    (s / "Notes_2_vc_01.txt").write_text("0.5 220.0 0.5\n")
    s = src["egmd"] = root / "egmd"
    _midi(s / "d1.mid", DRUMS)
    _wav(s / "d1.wav")
    (s / "e-gmd.csv").write_text("midi_filename,audio_filename,split\nd1.mid,d1.wav,train\n")
    s = src["slakh"] = root / "slakh"
    t = s / "train" / "Track00001"
    os.makedirs(t)
    (t / "metadata.yaml").write_text(
        "stems:\n  S00:\n    is_drum: false\n    program_num: 0\n")
    _midi(t / "MIDI" / "S00.mid", PIANO)
    _wav(t / "mix.wav")
    _wav(t / "stems" / "S00.wav")
    _guitarset(root / "gset")
    src["guitarset"] = root / "gset"
    s = root / "singing"
    for i in range(2):
        _json(s / f"song{i}.json", [[0.5, 1.0, 62.2], [1.2, 1.5, 67.0], [2.0, 2.2, 200.0]])
        _wav(s / f"song{i}.wav")
    _json(s / "orphan.json", [[0.0, 0.5, 60]])
    src["mir_st500"] = src["cmedia"] = src["mir1k"] = s
    s = root / "paired"
    _midi(s / "disc1" / "t1.mid", PIANO)
    _wav(s / "disc1" / "t1.wav")
    _midi(s / "disc1" / "orphan.mid", PIANO)
    src["rwc_pop"] = src["idmt_smt_bass"] = s
    return src


def _written(home):
    """{relative path: content} under a directory, with the directory's
    own path taken out of the index files."""
    out = {}
    for path in sorted(glob.glob(os.path.join(home, "**", "*"), recursive=True)):
        if os.path.isdir(path):
            continue
        rel = os.path.relpath(path, home)
        if path.endswith(".npz"):
            with np.load(path) as z:
                out[rel] = {k: z[k].tolist() for k in z.files}
        else:
            with open(path, "rb") as f:
                out[rel] = f.read().replace(home.encode(), b"<home>")
    return out


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    return _build_sources(tmp_path_factory.mktemp("sources"))


def test_the_port_registers_the_reference_converters():
    assert sorted(cv.CONVERTERS) == sorted(jax_cv.CONVERTERS)


@pytest.mark.parametrize("dataset", sorted(jax_cv.CONVERTERS))
def test_converter_writes_the_reference_files(dataset, sources, tmp_path):
    homes = {side: str(tmp_path / side) for side in ("jax", "port")}
    want = jax_cv.CONVERTERS[dataset](str(sources[dataset]), homes["jax"])
    got = cv.CONVERTERS[dataset](str(sources[dataset]), homes["port"])
    assert sorted(got) == sorted(want) and got
    port, ref = _written(homes["port"]), _written(homes["jax"])
    assert port and port == ref


# ---------------------------------------------------------------------------
# download and install_dataset
# ---------------------------------------------------------------------------

def _archive(tmp_path, kind):
    tree = tmp_path / f"tree_{kind}"
    (tree / "top").mkdir(parents=True)
    (tree / "top" / "x.txt").write_text("hello")
    arch = str(tmp_path / f"a.{kind}")
    if kind == "zip":
        with zipfile.ZipFile(arch, "w") as z:
            z.write(tree / "top" / "x.txt", "top/x.txt")
    else:
        with tarfile.open(arch, "w:gz") as t:
            t.add(tree / "top" / "x.txt", "top/x.txt")
    return arch


@pytest.mark.parametrize("kind", ["zip", "tar.gz"])
def test_fetch_and_extract_match_the_reference(kind, tmp_path):
    arch = _archive(tmp_path, kind)
    sha = download.sha256_file(arch)
    assert sha == jax_download.sha256_file(arch)
    outs = {}
    for side, mod in (("port", download), ("jax", jax_download)):
        work = tmp_path / side
        outs[side] = mod.fetch_and_extract(f"file://{arch}", str(work), sha256=sha)
        assert download.sha256_file(str(work / os.path.basename(arch))) == sha
    assert _written(outs["port"]) == _written(outs["jax"]) == {"top/x.txt": b"hello"}


def test_download_refuses_a_bad_checksum_and_a_traversal(tmp_path):
    src = tmp_path / "src.bin"
    src.write_bytes(np.random.default_rng(0).bytes(10_000))
    with pytest.raises(download.DownloadError, match="checksum"):
        download.download(f"file://{src}", str(tmp_path / "d.bin"), sha256="0" * 64)
    assert not os.path.exists(tmp_path / "d.bin")
    evil = str(tmp_path / "evil.tar")
    (tmp_path / "p.txt").write_text("x")
    with tarfile.open(evil, "w") as t:
        t.add(tmp_path / "p.txt", "../../evil.txt")
    with pytest.raises(download.DownloadError, match="unsafe"):
        download.extract(evil, str(tmp_path / "out"))


def test_install_dataset_via_a_local_archive_writes_the_reference_files(tmp_path):
    """--url file://...zip: fetch, extract, convert (guitarset), into the
    index files the port's loaders read."""
    from yourmt3_tpu_torch.data.indexes import load_file_list
    tree = tmp_path / "gs"
    _guitarset(tree, "00_BN1-129-Eb_comp")
    arch = str(tmp_path / "gs.zip")
    with zipfile.ZipFile(arch, "w") as z:
        for root, _, files in os.walk(tree):
            for fn in files:
                full = os.path.join(root, fn)
                z.write(full, os.path.relpath(full, tmp_path))
    homes = {side: str(tmp_path / f"home_{side}") for side in ("jax", "port")}
    jax_install(["guitarset", "--url", f"file://{arch}", "--data-home", homes["jax"]])
    install_dataset.main(["guitarset", "--url", f"file://{arch}",
                          "--data-home", homes["port"]])
    port, ref = _written(homes["port"]), _written(homes["jax"])
    assert port == ref
    idx = os.path.join(homes["port"], "yourmt3_indexes", "guitarset_train_file_list.json")
    assert len(load_file_list(idx)["tracks"]) == 1


# ---------------------------------------------------------------------------
# the demo, --url and profiling
# ---------------------------------------------------------------------------

def _song(path, seconds=2.2):
    sr = 16000
    t = np.arange(int(sr * seconds)) / sr
    write_wav(str(path), (0.2 * np.sin(2 * np.pi * 440 * t)).astype(np.float32), sr)


@pytest.fixture()
def fake_gradio(monkeypatch):
    captured = {}
    gr = types.ModuleType("gradio")

    class Comp:
        def __init__(self, *a, **k):
            pass

    class Interface:
        def __init__(self, fn=None, **k):
            captured["fn"] = fn

        def launch(self, **k):
            captured["launched"] = k

    gr.Audio = gr.Textbox = gr.File = Comp
    gr.Interface = Interface
    monkeypatch.setitem(sys.modules, "gradio", gr)
    return captured


@pytest.fixture()
def fake_yt_dlp(monkeypatch):
    """A yt_dlp whose download writes a short song where the options say."""
    mod = types.ModuleType("yt_dlp")

    class YoutubeDL:
        def __init__(self, opts):
            self.opts = opts

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def download(self, urls):
            _song(os.path.join(os.path.dirname(self.opts["outtmpl"]), "audio.wav"))

    mod.YoutubeDL = YoutubeDL
    monkeypatch.setitem(sys.modules, "yt_dlp", mod)


@pytest.fixture(scope="module")
def tiny_bundle():
    return api.init_model("t5_tiny", "mt3_full_plus_256", device="cpu",
                          num_encoder_layers=1, num_decoder_layers=1)


def test_demo_needs_gradio_and_yt_dlp_with_clear_errors(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    monkeypatch.setitem(sys.modules, "yt_dlp", None)
    with pytest.raises(RuntimeError, match="gradio"):
        app.build_demo(bundle=object())
    with pytest.raises(RuntimeError, match="yt-dlp"):
        app.fetch_youtube_audio("https://youtu.be/x", "unused")


@pytest.mark.parametrize("source", ["upload", "youtube", "nothing"])
def test_demo_transcribes_an_upload_or_a_youtube_url(source, fake_gradio, fake_yt_dlp,
                                                     tiny_bundle, tmp_path):
    app.build_demo(bundle=tiny_bundle)
    run = fake_gradio["fn"]
    if source == "nothing":
        with pytest.raises(ValueError, match="audio file or a YouTube URL"):
            run(None, "")
        return
    wav = str(tmp_path / "in.wav")
    _song(wav)
    out = run(wav, "") if source == "upload" else run(None, "https://youtu.be/fake")
    assert os.path.exists(out) and out.endswith(".mid")
    midi2note(out)  # a random model may write no note; the file parses


def test_transcribe_cli_fetches_and_transcribes_a_url(fake_yt_dlp, tmp_path):
    out = str(tmp_path / "out")
    mids = cli_transcribe.main(["--url", "https://youtu.be/fake", "-m", "t5_tiny",
                                "-t", "mt3_full_plus_256", "--repair-beam", "0",
                                "-o", out, "--cpu"])
    assert len(mids) == 1 and os.path.exists(mids[0]) and mids[0].startswith(out)


def test_profiling_trace_writes_a_trace_on_the_cpu(tmp_path):
    import torch
    with profiling.trace(str(tmp_path / "trace")) as t:
        with profiling.span("matmul"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    traces = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "matmul" in names
    assert any(e.key == "matmul" for e in t.prof.key_averages())
    assert t.summary["spans"]["matmul"]["count"] == 1
