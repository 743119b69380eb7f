"""The port's TSE data preparation (puresound_tpu_torch/egs/tse/local/:
parser.py, make_librispeech_metadata.py, create_vad_label.py,
create_metadata.sh) against the JAX recipe's: the parser end to end on the
toy corpus of tests/test_dataprep.py in a process where `jax` and
`puresound_tpu` cannot be imported, its manifests through the port's
`TseDataset` / collate; the same files as JAX's parser under one seed; the
bundled LibriSpeech tables through the port's `Parser`; the metadata table of
a FLAC corpus; the energy VAD bit for bit; create_metadata.sh on its default
tables; and an `ast` walk of the scripts' imports."""
import ast
import os
import random
import runpy
import subprocess
import sys
from argparse import Namespace

import numpy as np
import pytest
import torch

from puresound_tpu_torch.src.audio import AudioIO
from puresound_tpu_torch.tasks.tse import TseCollateFunc, TseDataset
from tests.test_dataprep import _toy_corpus
from tests.test_torch_eval_metrics import _write_flac

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LOCAL = os.path.join(REPO, "egs", "tse", "local")
LOCAL = os.path.join(REPO, "puresound_tpu_torch", "egs", "tse", "local")
SCRIPTS = ("parser.py", "make_librispeech_metadata.py", "create_vad_label.py")
MANIFESTS = ("wav2scp.txt", "wav2ref.txt", "ref2spk.txt", "wav2spk.txt", "ref2list.txt")
SPLITS = ("dev-clean", "dev-other", "test-clean", "test-other", "train-clean-100")
SR = 8000

# runs a script as __main__ with `jax`, `flax` and `puresound_tpu` unimportable
_BLOCKED = """
import runpy, sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'puresound_tpu'):
            raise ImportError('not importable here: ' + name)
sys.meta_path.insert(0, _Block())
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name='__main__')
"""


def _run_blocked(script, *args):
    return subprocess.run([sys.executable, "-c", _BLOCKED, os.path.join(LOCAL, script),
                           *map(str, args)], check=True, capture_output=True, text=True)


def _main(folder, script):
    return runpy.run_path(os.path.join(folder, script))["main"]


def test_parser_end_to_end_without_jax(tmp_path):
    corpus, meta, mixcsv = _toy_corpus(tmp_path)
    out = tmp_path / "manifest"
    _run_blocked("parser.py", mixcsv, out, meta, corpus)
    for fname in MANIFESTS:
        assert (out / fname).is_file(), fname
    assert len((out / "wav2scp.txt").read_text().strip().splitlines()) == 4
    ds = TseDataset(folder=str(out), resample_to=SR, max_length=1,
                    enroll_rule="fixed_length", enroll_augment=False)
    batch = TseCollateFunc()([ds[0], ds[1]])
    assert all(np.isfinite(np.asarray(v)).all() for v in batch.values()
               if isinstance(v, (np.ndarray, torch.Tensor)))
    assert np.isfinite(np.asarray(batch["process_wav"])).all()


def test_parser_writes_jax_parsers_files(tmp_path):
    """Under one `random` seed (the enrollment draws) the two parsers write
    the same five files byte for byte."""
    corpus, meta, mixcsv = _toy_corpus(tmp_path)
    texts = []
    for folder, name in ((JAX_LOCAL, "jax"), (LOCAL, "port")):
        out = tmp_path / name
        random.seed(3)
        _main(folder, "parser.py")(Namespace(meta_path=str(mixcsv), output_folder=str(out),
                                             corpus_metadata=str(meta),
                                             corpus_root=str(corpus)))
        texts.append([(out / f).read_bytes() for f in MANIFESTS])
    assert texts[0] == texts[1]


@pytest.mark.parametrize("split", SPLITS)
def test_bundled_librispeech_metadata_loads(split):
    """The bundled tables parse through the port's Parser into JAX's speaker
    pool, speaker for speaker."""
    path = os.path.join(JAX_LOCAL, "librispeech_metadata", split)
    got = runpy.run_path(os.path.join(LOCAL, "parser.py"))["Parser"].read_librispeech_metadata(
        path, insert_root="/corpus")
    want = runpy.run_path(os.path.join(JAX_LOCAL, "parser.py"))[
        "Parser"].read_librispeech_metadata(path, insert_root="/corpus")
    assert got == want
    assert len(got) > 30
    if split == "dev-clean":
        assert len(got) == 40 and got["1272"]["gender"] in ("M", "F")


def test_make_librispeech_metadata(tmp_path):
    """A FLAC corpus in LibriSpeech's layout: the port's table equals JAX's,
    and the port's parser reads it back."""
    split = tmp_path / "LibriSpeech" / "dev-clean"
    rng = np.random.default_rng(0)
    for spk, n in (("84", 2), ("174", 1)):
        for j in range(n):
            path = split / spk / "10" / f"{spk}-10-{j:04d}.flac"
            os.makedirs(path.parent, exist_ok=True)
            x = (3000 * rng.standard_normal((1, 1600 + 160 * j))).astype(np.int64)
            _write_flac(str(path), x, 16000, 192, ["independent"], [0, 1])
    speakers = tmp_path / "SPEAKERS.TXT"
    speakers.write_text("; ID | SEX | SUBSET\n84 | F | dev-clean\n")
    tables = []
    for folder, name in ((JAX_LOCAL, "jax.csv"), (LOCAL, "port.csv")):
        _main(folder, "make_librispeech_metadata.py")(Namespace(
            corpus_split=str(split), output_csv=str(tmp_path / name),
            speakers_file=str(speakers), relative_to=str(tmp_path / "LibriSpeech")))
        tables.append((tmp_path / name).read_text())
    assert tables[0] == tables[1]
    assert tables[1].count("\n") == 4 and ", U, " in tables[1] and ", F, " in tables[1]
    pool = runpy.run_path(os.path.join(LOCAL, "parser.py"))["Parser"].read_librispeech_metadata(
        str(tmp_path / "port.csv"))
    assert sorted(pool) == ["174", "84"] and len(pool["84"]["utts"]) == 2


def _signal(kind, rng):
    t = np.arange(2 * SR) / SR
    if kind == "bursts":
        x = 0.5 * np.sin(2 * np.pi * 220 * t) * (np.sin(2 * np.pi * 1.5 * t) > 0)
        return (x + 1e-3 * rng.standard_normal(t.size)).astype(np.float32)
    if kind == "noise":
        return (0.1 * rng.standard_normal(t.size)).astype(np.float32)
    return np.zeros(SR // 2, np.float32)


@pytest.mark.parametrize("kind", ["bursts", "noise", "silence"])
def test_energy_vad_bit_for_bit(rng, kind):
    x = _signal(kind, rng)
    got = runpy.run_path(os.path.join(LOCAL, "create_vad_label.py"))["energy_vad"](x, SR)
    want = runpy.run_path(os.path.join(JAX_LOCAL, "create_vad_label.py"))["energy_vad"](x, SR)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if kind == "bursts":
        assert 0.2 < got.mean() < 0.9


def test_create_vad_label_end_to_end(tmp_path, rng):
    """The script on a manifest of synthetic references, in a process without
    jax: its label files equal JAX's script's byte for byte."""
    refs = []
    for i, kind in enumerate(("bursts", "noise")):
        path = tmp_path / f"ref{i}.wav"
        AudioIO.save(_signal(kind, rng).reshape(1, -1), str(path), SR)
        refs.append(f"utt{i} {path}")
    outs = {}
    for name in ("jax", "port"):
        manifest = tmp_path / f"manifest_{name}"
        manifest.mkdir()
        (manifest / "wav2ref.txt").write_text("\n".join(refs) + "\n")
        if name == "port":
            _run_blocked("create_vad_label.py", manifest, tmp_path / f"vad_{name}")
        else:
            _main(JAX_LOCAL, "create_vad_label.py")(Namespace(
                manifest=str(manifest), output_folder=str(tmp_path / f"vad_{name}"),
                vad="energy"))
        outs[name] = [(tmp_path / f"vad_{name}" / f"utt{i}.vad.wav").read_bytes()
                      for i in range(2)]
        lines = (manifest / "ref2vad.txt").read_text().split()
        assert lines[0] == "utt0" and lines[1].endswith("utt0.vad.wav")
    assert outs["jax"] == outs["port"]


def test_create_metadata_sh_on_bundled_tables(tmp_path):
    """create_metadata.sh with its four arguments, the LibriSpeech tables
    defaulting to the bundled ones: every split's five manifests, from the
    port's parser in a process without jax."""
    meta_dir = tmp_path / "libri2mix"
    meta_dir.mkdir()
    tables = {"train": ("mixture_train-100_mix_clean.csv", "train-clean-100"),
              "dev": ("mixture_dev_mix_clean.csv", "dev-clean"),
              "eval": ("mixture_test_mix_clean.csv", "test-clean")}
    for split, (csv, table) in tables.items():
        with open(os.path.join(JAX_LOCAL, "librispeech_metadata", table)) as f:
            rows = [l.split(", ") for l in f.read().splitlines()[1:] if l.strip()]
        by_spk = {}
        for r in rows:
            by_spk.setdefault(r[1], r[0])
        u1, u2 = list(by_spk.values())[:2]
        (meta_dir / csv).write_text("mixture_ID,mixture_path,source_1_path,source_2_path,"
                                    f"length\n{u1}_{u2},/m.wav,/s1.wav,/s2.wav,16000\n")
    # the script's python3 runs with jax and puresound_tpu unimportable
    shim = tmp_path / "bin"
    shim.mkdir()
    (shim / "python3").write_text(f'#!/bin/sh\nexec "{sys.executable}" -c "$BLOCKED" "$@"\n')
    os.chmod(shim / "python3", 0o755)
    env = dict(os.environ, PATH=f"{shim}:{os.environ['PATH']}", BLOCKED=_BLOCKED)
    out = tmp_path / "data"
    subprocess.run(["bash", os.path.join(LOCAL, "create_metadata.sh"), str(meta_dir),
                    "/corpus", str(out)], check=True, capture_output=True, env=env)
    for split in tables:
        for fname in MANIFESTS:
            lines = (out / split / fname).read_text().splitlines()
            assert len(lines) == 2, (split, fname)
        enroll = (out / split / "ref2list.txt").read_text().split()
        assert all(p.startswith("/corpus/") for p in enroll if p.endswith(".flac"))


@pytest.mark.parametrize("script", SCRIPTS)
def test_scripts_import_no_jax(script):
    """The port's data-prep scripts import neither jax nor the JAX package."""
    tree = ast.parse(open(os.path.join(LOCAL, script)).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "puresound_tpu_torch.src.utils" in names
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "flax", "puresound_tpu")]
    assert not bad, bad


def test_create_metadata_sh_runs_the_ports_parser():
    text = open(os.path.join(LOCAL, "create_metadata.sh")).read()
    assert '"$SCRIPT_DIR/parser.py"' in text
    assert "egs/tse/local/librispeech_metadata" in text
    assert "puresound_tpu." not in text and "import" not in text
