"""IMDB in the port against tlie_tpu on the CPU: the tokenizer and the
vocabulary order, the splits (tokens, labels, lengths), the vocabulary and
its size bit for bit at char and word level, with and without ``<bos>``,
on the aclImdb fixture (``tests/fixtures/aclImdb``) and on the synthetic
corpus, the fallback line where no files are, the registry, and
``prep_batch`` of a padded IMDB batch.

tlie_tpu first tries a Hugging Face ``imdb`` cache through the ``datasets``
package, a path that may reach the network; these tests replace it with
one that finds nothing, so both packages read the same files."""

import numpy as np
import pytest

from tlie_tpu.data import imdb as jax_imdb
from tlie_tpu.training.steps import prep_batch as jax_prep_batch
from tlie_tpu_torch.data import DATASETS, IMDB
from tlie_tpu_torch.data import imdb as port_imdb
from tlie_tpu_torch.training import prep_batch

FIXTURE = "tests/fixtures/aclImdb"


@pytest.fixture(autouse=True)
def no_hugging_face(monkeypatch):
    monkeypatch.setattr(jax_imdb, "_load_hf_imdb", lambda data_dir: None)


def _both(**cfg):
    """(port's, tlie_tpu's) IMDB, each set up."""
    port = IMDB(**cfg)
    port.setup()
    ref = jax_imdb.IMDB(**cfg)
    ref.setup()
    return port, ref


@pytest.mark.parametrize("text", [
    "A <br />film: \"great\"; it's (really) good! Isn't it? Yes... 10/10",
    "  Tabs\tand\nnewlines,COMMAS,,and CAPS  ", "", "l'amour d'été (déjà vu)!"])
def test_basic_english_tokenize_matches_tlie_tpus(text):
    assert port_imdb.basic_english_tokenize(text) == jax_imdb.basic_english_tokenize(text)


def test_build_vocab_matches_tlie_tpus_order():
    """Specials first, then count descending with lexicographic ties, the
    tokens below ``min_freq`` left out."""
    lists = [list("banana"), list("bandana"), ["x", "y", "y"], ["b", "a"]]
    for min_freq in (1, 2, 3):
        got = port_imdb.build_vocab(lists, min_freq, ["<pad>", "<unk>", "<eos>"])
        assert got == jax_imdb.build_vocab(lists, min_freq, ["<pad>", "<unk>", "<eos>"])
        assert list(got.values()) == list(range(len(got)))


_CASES = {
    "fixture_char": dict(data_dir=FIXTURE, l_max=32, min_freq=1),
    "fixture_word": dict(data_dir=FIXTURE, l_max=8, min_freq=1, level="word"),
    "fixture_char_bos": dict(data_dir=FIXTURE, l_max=16, min_freq=2, append_bos=True),
    "fixture_default_min_freq": dict(data_dir=FIXTURE, l_max=64),
    "synthetic_char": dict(synthetic=True, synthetic_train=24, synthetic_test=8, l_max=512),
    "synthetic_word": dict(synthetic=True, synthetic_train=24, synthetic_test=8, l_max=128,
                           level="word", min_freq=3, seed=7),
    "synthetic_char_full_l_max": dict(synthetic=True, synthetic_train=6, synthetic_test=2),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_imdb_arrays_equal_tlie_tpus_bit_for_bit(case):
    """Both splits' tokens (n, l_max) int64, labels and lengths (the
    specials counted, reviews cut to the budget), the vocabulary, its size
    and <pad>'s id, equal to tlie_tpu's."""
    port, ref = _both(**_CASES[case])
    assert port.vocab == ref.vocab and port.vocab_size == ref.vocab_size
    assert port.pad_id == ref.pad_id == 0
    for split in ("train", "test"):
        x, y, lengths = port.split(split)
        want = (getattr(ref, f"{split}_inputs"), getattr(ref, f"{split}_labels"),
                getattr(ref, f"{split}_lengths"))
        for got, ref_arr in zip((x, y, lengths), want):
            assert got.dtype == ref_arr.dtype == np.int64
            np.testing.assert_array_equal(got, ref_arr)
        assert x.shape == (len(y), port.l_max) and lengths.max() <= port.l_max
        assert np.all(x[np.arange(port.l_max)[None, :] >= lengths[:, None]] == port.pad_id)
        if port.append_eos:
            np.testing.assert_array_equal(x[np.arange(len(y)), lengths - 1], port.vocab["<eos>"])
    if case.startswith("fixture"):
        np.testing.assert_array_equal(port.split("train")[1], [1, 1, 0, 0])


def test_missing_files_fall_back_to_the_synthetic_corpus_with_tlie_tpus_line(tmp_path, capsys):
    """No aclImdb folders under ``data_dir``: both print the same two lines
    and build the same synthetic splits; ``synthetic: true`` prints only the
    summary."""
    cfg = dict(data_dir=str(tmp_path), synthetic_train=6, synthetic_test=2, l_max=256)
    port = IMDB(**cfg)
    port.setup()
    ours = capsys.readouterr().out
    ref = jax_imdb.IMDB(**cfg)
    ref.setup()
    assert ours == capsys.readouterr().out and "downloads are disabled" in ours
    np.testing.assert_array_equal(port.split("test")[0], ref.test_inputs)
    IMDB(synthetic=True, synthetic_train=2, synthetic_test=2, l_max=64).setup()
    assert "downloads are disabled" not in capsys.readouterr().out
    with pytest.raises(ValueError, match="level"):
        IMDB(synthetic=True, synthetic_train=2, synthetic_test=2, level="byte").setup()


def test_imdb_registers_with_tlie_tpus_defaults():
    assert DATASETS["imdb"] is IMDB
    assert IMDB.init_defaults == jax_imdb.IMDB(synthetic=True).init_defaults
    assert IMDB.d_output == 2 and IMDB.get_metrics() is not None


def test_prep_batch_of_a_padded_imdb_batch_matches_tlie_tpus():
    """A loader batch (x, y, {"lengths"}) becomes ``(tokens, lengths)``, the
    lengths float32, as tlie_tpu's ``prep_batch`` gives it; with
    ``lang_model`` (eval_eig's analysis batch) the tokens alone."""
    port = IMDB(synthetic=True, synthetic_train=4, synthetic_test=4, l_max=128)
    x, y, lengths = port.split("train")
    (tokens, lens), labels = prep_batch((x, y, {"lengths": lengths}), 128, 1, device="cpu")
    (jt, jl), jy = jax_prep_batch((x, y, {"lengths": lengths}), 128, 1)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jy))
    assert lens.dtype.is_floating_point and str(np.asarray(jl).dtype) == "float32"
    alone, _ = prep_batch((x, y, {"lengths": lengths}), 128, 1, lang_model=True, device="cpu")
    np.testing.assert_array_equal(alone.numpy(), x)
