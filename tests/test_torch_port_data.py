"""The port's tokenizers and preprocess against the JAX package.

``ByteTokenizer``, ``BPETokenizer`` (train, save/load, encode, decode),
the native encoder (``csrc/bpe.cpp``, built under ``build/native/``),
``get_tokenizer``, ``split_documents``, ``token_dtype``,
``write_token_file``, ``preprocess`` and the ``data_preprocess`` CLI of
``pretraining_llm_tpu_torch``, each held against
``pretraining_llm_tpu.data`` on the same inputs: text from the repo's
``data/parity/corpus.txt`` and from numpy draws with a seed. Bars: equal
merge lists, equal ids, files that load in the other package, and token
files byte for byte equal to the JAX package's.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu.data import bpe as jbpe
from pretraining_llm_tpu.data import preprocess as jpre
from pretraining_llm_tpu_torch import data_preprocess as tpre_cli
from pretraining_llm_tpu_torch.data import bpe as tbpe
from pretraining_llm_tpu_torch.data import loader as tloader
from pretraining_llm_tpu_torch.data import native_bpe
from pretraining_llm_tpu_torch.data import preprocess as tpre
from pretraining_llm_tpu_torch.data.tokenizer import get_tokenizer

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def corpus():
    """32 KB of the parity corpus, cut into 40 documents at line ends."""
    text = (ROOT / "data" / "parity" / "corpus.txt").read_text()[:32_000]
    lines = text.split("\n")
    return ["\n".join(lines[i::40]) for i in range(40)]


@pytest.fixture(scope="module")
def trained(corpus):
    """The same corpus trained to vocab 320 by both packages."""
    return jbpe.BPETokenizer.train(corpus, 320), tbpe.BPETokenizer.train(corpus, 320)


def _samples(corpus):
    rng = np.random.default_rng(0)
    return corpus[:3] + [
        "", "a", "aaaaaaaa", "the the the", "éèê unicode café naïve ☃",
        "".join(rng.choice(list("abcdefgh \n\t"), 2000)),
        "".join(chr(c) for c in rng.integers(32, 1000, 500)),
    ]


def test_byte_tokenizer_matches_jax():
    j, t = jbpe.ByteTokenizer(), tbpe.ByteTokenizer()
    text = "Hello, world! éàü ☃"
    assert t.encode_ordinary(text) == j.encode_ordinary(text)
    assert t.decode(t.encode_ordinary(text)) == text
    assert (t.eot_token, t.n_vocab) == (j.eot_token, j.n_vocab) == (256, 257)
    assert t.decode([104, 105, 256]) == j.decode([104, 105, 256]) == "hi"


def test_bpe_train_gives_jax_merges_and_ids(trained, corpus):
    j, t = trained
    assert t.merges == j.merges and len(t.merges) == 320 - 257
    assert t.special_tokens == j.special_tokens and t.n_vocab == j.n_vocab == 320
    for text in _samples(corpus):
        ids = t.encode_ordinary(text)
        assert ids == j.encode_ordinary(text), text[:40]
        assert t.decode(ids) == j.decode(ids) == text
    assert len(t.encode_ordinary(corpus[0])) < len(corpus[0].encode())  # merges compress


def test_bpe_training_stops_when_no_pair_repeats():
    j = jbpe.BPETokenizer.train(["abc abd"], 400)
    t = tbpe.BPETokenizer.train(["abc abd"], 400)
    assert t.merges == j.merges and len(t.merges) < 400 - 257


def test_bpe_files_load_in_either_package(trained, corpus, tmp_path):
    j, t = trained
    t.save(str(tmp_path / "port.json"))
    j.save(str(tmp_path / "jax.json"))
    from_port = jbpe.BPETokenizer.load(str(tmp_path / "port.json"))
    from_jax = tbpe.BPETokenizer.load(str(tmp_path / "jax.json"))
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads((tmp_path / "jax.json").read_text())
    for text in _samples(corpus)[:5]:
        assert from_port.encode_ordinary(text) == from_jax.encode_ordinary(text) == t.encode_ordinary(text)
    via_name = get_tokenizer(str(tmp_path / "jax.json"))
    assert via_name.merges == t.merges


def test_native_encoder_matches_the_python_sweep(trained, corpus):
    _, t = trained
    lib, why = native_bpe.load_library()
    assert lib is not None, why  # a host C++ compiler is present here
    enc = native_bpe.NativeBpeEncoder(t.merges)
    for text in _samples(corpus):
        data = text.encode("utf-8")
        assert enc.encode_bytes(data) == t._encode_python(list(data)), text[:40]
    t.encode_ordinary("warm")
    assert t.encoder == "native"
    enc.close()


def test_encoder_falls_back_to_the_python_sweep(trained, corpus, monkeypatch):
    _, t = trained
    monkeypatch.setattr(native_bpe, "load_library", lambda: (None, "no compiler"))
    fresh = tbpe.BPETokenizer(t.merges)
    text = corpus[1]
    assert fresh.encode_ordinary(text) == t.encode_ordinary(text)
    assert fresh.encoder == "python"


def test_get_tokenizer_names(monkeypatch):
    assert get_tokenizer("byte").n_vocab == 257
    with pytest.raises(ValueError, match="unknown tokenizer"):
        get_tokenizer("nonsense")

    class Offline:  # tiktoken without its data file, and no network
        @staticmethod
        def get_encoding(name):
            raise OSError(f"cannot fetch {name}")

    get_tokenizer.cache_clear()
    monkeypatch.setitem(sys.modules, "tiktoken", Offline)
    with pytest.raises(RuntimeError, match="tokenizer_name='byte'"):
        get_tokenizer("gpt2")
    monkeypatch.setitem(sys.modules, "tiktoken", None)  # not installed
    with pytest.raises(RuntimeError, match="tiktoken"):
        get_tokenizer("r50k_base")
    get_tokenizer.cache_clear()


# ---------------------------------------------------------------------------
# Preprocess
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,frac,seed", [(100, 0.1, 42), (7, 0.0005, 1), (1, 0.5, 3)])
def test_split_documents_matches_jax(n, frac, seed):
    docs = [f"doc {i}" for i in range(n)]
    assert tpre.split_documents(docs, frac, seed) == jpre.split_documents(docs, frac, seed)


def test_token_dtype_matches_jax():
    for n in (257, 65536, 65537, 100_000):
        assert tpre.token_dtype(n) == jpre.token_dtype(n)


@pytest.mark.parametrize("tokenizer", ["byte", "bpe"])
def test_write_token_file_is_jax_bytes(trained, corpus, tmp_path, tokenizer):
    name = "byte"
    if tokenizer == "bpe":
        name = str(tmp_path / "bpe.json")
        trained[1].save(name)
    n_t = tpre.write_token_file(corpus[:6], str(tmp_path / "t.bin"), name, num_proc=1)
    n_j = jpre.write_token_file(corpus[:6], str(tmp_path / "j.bin"), name, num_proc=1)
    assert n_t == n_j
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()


def _same_outputs(tmp_path, kw_port, kw_jax):
    tp = tpre.preprocess(out_dir=str(tmp_path / "port"), **kw_port)
    jp = jpre.preprocess(out_dir=str(tmp_path / "jax"), **kw_jax)
    for a, b in zip(tp, jp):
        assert Path(a).read_bytes() == Path(b).read_bytes(), a
    return tp


def test_preprocess_txt_and_jsonl_are_jax_bytes(trained, corpus, tmp_path):
    name = str(tmp_path / "bpe.json")
    trained[1].save(name)
    txts = []
    for i, doc in enumerate(corpus[:5]):
        txts.append(str(tmp_path / f"d{i}.txt"))
        Path(txts[-1]).write_text(doc)
    jl = tmp_path / "docs.jsonl"
    jl.write_text("\n".join(json.dumps({"text": d}) for d in corpus[5:]) + "\n\n")
    kw = dict(input_files=txts + [str(jl)], tokenizer_name=name, val_fraction=0.1, seed=7, num_proc=1)
    train_path, val_path = _same_outputs(tmp_path, kw, kw)
    x, y = next(tloader.get_batch_iterator(train_path, 2, 32, seed=0))
    assert x.shape == (2, 32) and (x < 320).all() and (x[:, 1:] == y[:, :-1]).all()
    assert np.memmap(val_path, dtype=np.uint16, mode="r").size > 0


def test_preprocess_worker_processes_give_jax_bytes(corpus, tmp_path):
    """More than 8 documents: the port encodes in two spawned workers."""
    jl = tmp_path / "docs.jsonl"
    jl.write_text("\n".join(json.dumps({"text": d}) for d in corpus[:12]))
    base = dict(input_files=[str(jl)], tokenizer_name="byte", val_fraction=0.2, seed=1)
    _same_outputs(tmp_path, dict(base, num_proc=2), dict(base, num_proc=1))


def test_preprocess_one_document_corpus_and_errors(corpus, tmp_path):
    one = tmp_path / "one.txt"
    one.write_text(corpus[0])
    kw = dict(input_files=[str(one)], tokenizer_name="byte", val_fraction=0.0005, num_proc=1)
    _same_outputs(tmp_path, kw, kw)
    with pytest.raises(ValueError, match="input_files or dataset_name"):
        tpre.preprocess(out_dir=str(tmp_path / "x"))
    empty = tmp_path / "empty.jsonl"
    empty.write_text("\n")
    with pytest.raises(ValueError, match="no documents"):
        tpre.preprocess(input_files=[str(empty)], out_dir=str(tmp_path / "x"), tokenizer_name="byte")


def test_preprocess_dataset_route_needs_the_datasets_package(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(RuntimeError, match="datasets"):
        tpre.preprocess(dataset_name="openwebtext", out_dir=str(tmp_path), tokenizer_name="byte")


def test_data_preprocess_cli_on_cpu_gives_jax_bytes(corpus, tmp_path):
    src = tmp_path / "c.txt"
    src.write_text(corpus[2])
    tp = tpre_cli.main(["--input", str(src), "--out_dir", str(tmp_path / "port"), "--tokenizer", "byte",
                        "--val_fraction", "0.05", "--device", "cpu"])
    jp = jpre.preprocess(input_files=[str(src)], out_dir=str(tmp_path / "jax"), tokenizer_name="byte",
                         val_fraction=0.05)
    for a, b in zip(tp, jp):
        assert Path(a).read_bytes() == Path(b).read_bytes()


def test_data_preprocess_cli_defaults_to_the_gpu(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "c.txt"
    src.write_text(corpus[2])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpre_cli.main(["--input", str(src), "--out_dir", str(tmp_path / "port"), "--tokenizer", "byte"])
    assert not (tmp_path / "port").exists()
