"""The port's data side of training (data/feature_cache.py, data/sampler.py,
data/dataset.py) against the JAX package's on the CPU, on the same inputs.

- Features: the port's ``compute_track_features`` on the CPU (the plain
  featurizer) against JAX's ``use_pallas=False`` within atol 2e-4 / rtol
  1e-4, at bucket 256 with several buckets and a partial one, at the
  snip-edges geometry and for a zero-length wave; a cache written by either
  package reads back in the other.
- Tables: the sampler's rows equal JAX's ``df.to_dict("records")``
  exactly (the same ``RandomState`` stream, the same visiting order) and
  the CSVs are equal byte for byte.
- Batches: ``LadDataset.batches`` equal to JAX's bit for bit (order,
  inputs, lengths, labels), ``ResidentLadDataset`` equal to streamed in
  float32 and to JAX's ``ml_dtypes`` rounding in bfloat16.
"""

import numpy as np
import pytest
import torch

from laughter_detection_icsi_tpu.config import FeatConfig as JFeatConfig
from laughter_detection_icsi_tpu.data import dataset as jds
from laughter_detection_icsi_tpu.data import feature_cache as jfc
from laughter_detection_icsi_tpu.data import sampler as jsm
from laughter_detection_icsi_tpu.eval import indices as jidx
from laughter_detection_icsi_tpu.eval import transcript as jtr
from laughter_detection_icsi_tpu_torch.config import FeatConfig
from laughter_detection_icsi_tpu_torch.data import audio
from laughter_detection_icsi_tpu_torch.data import dataset as tds
from laughter_detection_icsi_tpu_torch.data import feature_cache as tfc
from laughter_detection_icsi_tpu_torch.data import sampler as tsm
from laughter_detection_icsi_tpu_torch.eval import indices as tidx
from laughter_detection_icsi_tpu_torch.eval import transcript as ttr
from tests.fixtures.torch_weights import few_torch_threads  # noqa: F401

TOL = dict(atol=2e-4, rtol=1e-4)  # tests/test_fbank_pallas.py's feature tolerance
BUCKET = 256
SECONDS = {"Btr001": 60, "Bmr021": 100}  # the synthetic corpus's meeting lengths


def _wave(n: int, seed: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    env = 0.05 + 0.6 * np.sin(np.linspace(0, 9, n)) ** 2
    return (r.standard_normal(n) * 0.2 * env).astype(np.float32)


@pytest.mark.parametrize("case", ["buckets_and_a_partial", "snip_edges", "zero_length",
                                  "one_frame"])
def test_track_features_match_jax(case):
    snip = case == "snip_edges"
    n = {"zero_length": 0, "one_frame": 100}.get(case, 160 * (2 * BUCKET + 77) + 33)
    wave = _wave(n, seed=1)
    got = tfc.compute_track_features(wave, FeatConfig(snip_edges=snip), bucket_frames=BUCKET,
                                     device="cpu")
    want = jfc.compute_track_features(wave, JFeatConfig(snip_edges=snip), bucket_frames=BUCKET,
                                      use_pallas=False)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    if case == "buckets_and_a_partial":
        assert got.shape[0] == 2 * BUCKET + 77
    np.testing.assert_allclose(got, want, **TOL)
    half = tfc.compute_track_features(wave, FeatConfig(snip_edges=snip), bucket_frames=BUCKET,
                                      dtype=np.float16, device="cpu")
    assert half.dtype == np.float16 and half.shape == got.shape


def test_track_features_run_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfc.compute_track_features(_wave(16000, 2))


def test_caches_cross_between_the_packages(tmp_path):
    waves = {("Bmr021", "chan0"): _wave(16000 * 3 + 17, 3), ("Btr001", "chanA"): _wave(9000, 4)}
    tc = tfc.FeatureCache(str(tmp_path / "port"))
    jc = jfc.FeatureCache(str(tmp_path / "jax"))
    for (m, c), w in waves.items():
        tc.add_track(m, c, w, bucket_frames=BUCKET, device="cpu")
        jc.add_track(m, c, w, bucket_frames=BUCKET, use_pallas=False)
    assert (tmp_path / "port" / "manifest.json").read_text() == \
        (tmp_path / "jax" / "manifest.json").read_text()
    read_by_jax, read_by_port = jfc.FeatureCache(str(tmp_path / "port")), tfc.FeatureCache(
        str(tmp_path / "jax"))
    assert read_by_jax.keys() == read_by_port.keys() == sorted(f"{m}/{c}" for m, c in waves)
    for m, c in waves:
        assert read_by_jax.has(m, c, dtype=np.float32) and read_by_port.has(m, c, dtype=np.float32)
        np.testing.assert_array_equal(read_by_jax.track(m, c), tc.track(m, c))
        np.testing.assert_array_equal(read_by_port.track(m, c), jc.track(m, c))
        np.testing.assert_allclose(tc.track(m, c), jc.track(m, c), **TOL)
        for start, dur, pad in ((0.5, 1.0, 100), (2.9, 1.0, 100), (0.0, 0.3, None), (7.0, 1.0, 100)):
            np.testing.assert_array_equal(read_by_port.cut(m, c, start, dur, pad),
                                          jc.cut(m, c, start, dur, pad))


def test_has_retrack_and_sample_rate(tmp_path):
    cache = tfc.FeatureCache(str(tmp_path / "c"))
    cache.add_track("Bmr021", "chan0", _wave(8000, 5), bucket_frames=BUCKET, device="cpu")
    assert cache.has("Bmr021", "chan0") and cache.has("Bmr021", "chan0", dtype=np.float32)
    assert not cache.has("Bmr021", "chan0", dtype=np.float16)
    assert not tfc.FeatureCache(str(tmp_path / "c"), cfg=FeatConfig(num_filters=40)).has(
        "Bmr021", "chan0")
    assert not cache.has("Bmr021", "chan1")
    old = cache.track("Bmr021", "chan0")
    gen = cache.generation
    cache.add_track("Bmr021", "chan0", _wave(16000, 6), bucket_frames=BUCKET, device="cpu")
    new = cache.track("Bmr021", "chan0")
    assert cache.generation == gen + 1 and new is not old and new.shape[0] == 100 > old.shape[0]
    assert sorted(p.name for p in (tmp_path / "c" / "Bmr021").iterdir()) == ["chan0.npy"]
    with pytest.raises(KeyError, match="not in feature cache"):
        cache.track("Bmr021", "chan1")
    wav = str(tmp_path / "8k.wav")
    audio.write_wav(wav, (_wave(8000, 7) * 32767).astype(np.int16), 8000)
    with pytest.raises(ValueError, match="sample rate 8000"):
        cache.add_audio_file("Bmr021", "chan1", wav, device="cpu")
    assert not cache.has("Bmr021", "chan1")


# --------------------------------------------------------------------------- #
# Sample tables
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def stores(synthetic_corpus):
    tdir = str(synthetic_corpus.transcript_dir)
    j = jtr.TranscriptStore(tdir)
    t = ttr.TranscriptStore(tdir)
    return dict(jax=(j, jidx.build_indices(j)), port=(t, tidx.build_indices(t)))


TABLES = {
    "structured": (dict(num_laugh_samples=10, num_non_laugh_samples=10), False),
    "random": (dict(num_laugh_samples=3, num_non_laugh_samples=5, random=True), False),
    "noise_from_speech_bug": (dict(num_laugh_samples=2, num_non_laugh_samples=20), True),
    "meeting_filter": (dict(num_laugh_samples=4, num_non_laugh_samples=10,
                            meeting_id="Btr001", chan_id="chan1"), False),
}


def tables(stores, name):
    kw, bug = TABLES[name]
    j = jsm.DataFrameSampler(*stores["jax"], noise_from_speech_bug=bug).create_data_dfs(**kw)
    t = tsm.DataFrameSampler(*stores["port"], noise_from_speech_bug=bug).create_data_dfs(**kw)
    return j, t


@pytest.mark.parametrize("name", sorted(TABLES))
def test_sampler_tables_equal_jax_exactly(stores, tmp_path, name):
    j, t = tables(stores, name)
    assert list(t) == list(j) == ["train", "dev", "test"]
    for split in j:
        assert t[split] == j[split].to_dict("records"), split
        assert all(list(r) == tsm.COLS for r in t[split])
    assert sum(len(v) for v in t.values()) > 0
    jsm.write_data_dfs(j, str(tmp_path / "jax"))
    tsm.write_data_dfs(t, str(tmp_path / "port"))
    for split in j:
        name_ = f"{split}_df.csv"
        assert (tmp_path / "port" / name_).read_bytes() == (tmp_path / "jax" / name_).read_bytes()
        assert tds.load_split_df(str(tmp_path / "port"), split) == \
            jds.load_split_df(str(tmp_path / "jax"), split).to_dict("records")


def test_sampler_mix_and_guards(stores):
    _, t = tables(stores, "structured")
    train = t["train"]
    laughs = [r for r in train if r["label"] == 1]
    assert len(laughs) == 10 * 4  # Btr001's four laugh-typed segments, short and breath ones too
    store, _ = stores["port"]
    speech = {(s.meeting_id, s.chan_id, s.start) for s in store.speech}
    noise = {(s.meeting_id, s.chan_id, s.start) for s in store.noise}
    negatives = [r for r in train if r["label"] == 0]
    kinds = [("speech" if (r["meeting_id"], r["chan_id"], r["start"]) in speech
              else "noise" if (r["meeting_id"], r["chan_id"], r["start"]) in noise else "silence")
             for r in negatives]
    assert (kinds.count("silence"), kinds.count("noise"), kinds.count("speech")) == (28, 4, 8)
    sampler = tsm.DataFrameSampler(*stores["port"])
    with pytest.raises(ValueError, match="chan_id filter requires meeting_id"):
        sampler.create_data_dfs(chan_id="chan0")
    with pytest.raises(RuntimeError, match="no channel info"):
        sampler.random_non_laugh(1.0, "Bxx999")
    with pytest.raises(AssertionError, match="not in split"):
        tsm._sanity_check(t["dev"], "train")


# --------------------------------------------------------------------------- #
# Datasets
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def corpus_cache(stores, tmp_path_factory):
    """Features of the synthetic corpus's four tracks (plain featurizer) in a
    cache both packages read, and the structured tables through CSV."""
    root = tmp_path_factory.mktemp("torch_data")
    cache = tfc.FeatureCache(str(root / "feats"))
    for i, (m, secs) in enumerate(sorted(SECONDS.items())):
        for c in ("chan0", "chan1"):
            cache.add_track(m, c, _wave(16000 * secs, 10 + i), bucket_frames=4096, device="cpu")
    _, t = tables(stores, "structured")
    tsm.write_data_dfs(t, str(root / "dfs"))
    return root


def both(root, split="train", cache_dir="feats"):
    return (tds.LadDataset(tds.load_split_df(str(root / "dfs"), split),
                           tfc.FeatureCache(str(root / cache_dir))),
            jds.LadDataset(jds.load_split_df(str(root / "dfs"), split),
                           jfc.FeatureCache(str(root / cache_dir))))


def assert_same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert set(g) == set(w) == {"inputs", "input_lens", "is_laugh"}
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("kw", [dict(batch_size=16, seed=3), dict(batch_size=13, seed=4, shuffle=False),
                                dict(batch_size=16, seed=5, drop_remainder=True),
                                dict(batch_size=8, seed=6, skip_assembly=3),
                                dict(batch_size=32, seed=7, prefetch=0)],
                         ids=["shuffled", "in_order", "drop_remainder", "skip_assembly", "no_prefetch"])
def test_streamed_batches_bit_equal_jax(corpus_cache, kw):
    port, jax_ = both(corpus_cache)
    assert len(port) == len(jax_) == 80
    assert_same_batches(port.batches(**kw), jax_.batches(**kw))
    if kw.get("drop_remainder"):
        assert all(len(b["is_laugh"]) == 16 for b in port.batches(**kw))
    for i in (0, 17, 79):
        e, w = port.example(i), jax_.example(i)
        np.testing.assert_array_equal(e["inputs"], w["inputs"])
        assert e["input_lens"] == w["input_lens"] and e["is_laugh"] == w["is_laugh"]
    one = port._assemble(np.arange(80))
    for i in (0, 17, 79):
        np.testing.assert_array_equal(one["inputs"][i], port.example(i)["inputs"])


def test_zero_frame_track_and_plan_invalidation(corpus_cache, tmp_path):
    import shutil

    shutil.copytree(corpus_cache / "feats", tmp_path / "feats")
    shutil.copytree(corpus_cache / "dfs", tmp_path / "dfs")
    port, jax_ = both(tmp_path, "dev")
    kw = dict(batch_size=10, seed=2)
    assert_same_batches(port.batches(**kw), jax_.batches(**kw))  # plans built
    # Retrack Bmr021/chan1 as a zero-frame track in both caches.
    for cache, add in ((port.cache, dict(device="cpu")), (jax_.cache, dict(use_pallas=False))):
        cache.add_track("Bmr021", "chan1", _wave(60, 9), bucket_frames=BUCKET, **add)
    assert port.cache.track("Bmr021", "chan1").shape == (0, 44)
    got, want = list(port.batches(**kw)), list(jax_.batches(**kw))
    assert_same_batches(got, want)
    rows = [i for i, r in enumerate(port.df) if r["chan_id"] == "chan1"]
    assert rows
    for i in rows:
        assert not port.example(i)["inputs"].any()
    assert not port._assemble(np.asarray(rows))["inputs"].any()


def test_prefetch_hands_an_assembly_error_to_the_consumer(corpus_cache):
    port, jax_ = both(corpus_cache)
    port.df[5] = dict(port.df[5], meeting_id="Bxx999")
    jax_.df.loc[5, "meeting_id"] = "Bxx999"
    for ds in (port, jax_):
        ds.__dict__.pop("_plan_cache", None)
        with pytest.raises(KeyError, match="Bxx999"):
            list(ds.batches(batch_size=8, prefetch=2))


def test_local_rows_take_one_process(corpus_cache):
    """Each process's block of every batch, as JAX's ``local_rows``; its
    checks."""
    port, jax_ = both(corpus_cache)
    assert_same_batches(port.batches(8, seed=1, local_rows=(0, 1)), port.batches(8, seed=1))
    for rows in ((0, 2), (1, 2), (2, 4)):
        assert_same_batches(port.batches(8, seed=2, drop_remainder=True, local_rows=rows),
                            jax_.batches(8, seed=2, drop_remainder=True, local_rows=rows))
    whole = list(port.batches(8, seed=2, drop_remainder=True, prefetch=0))
    halves = [list(port.batches(8, seed=2, drop_remainder=True, local_rows=(r, 2)))
              for r in range(2)]
    for w, a, b in zip(whole, *halves):
        np.testing.assert_array_equal(np.concatenate([a["inputs"], b["inputs"]]), w["inputs"])
    with pytest.raises(ValueError, match="needs drop_remainder=True"):
        next(port.batches(8, local_rows=(0, 2)))
    with pytest.raises(ValueError, match="not divisible by num_processes 3"):
        next(port.batches(8, drop_remainder=True, local_rows=(0, 3)))
    with pytest.raises(ValueError, match="bad process id"):
        next(port.batches(8, local_rows=(1, 1)))


@pytest.mark.parametrize("transfer_dtype", [None, "bfloat16"])
def test_resident_equals_streamed_and_jax(corpus_cache, transfer_dtype):
    port, jax_ = both(corpus_cache)
    res = tds.ResidentLadDataset(port, transfer_dtype, assemble_chunk=24, device="cpu")
    jres = jds.ResidentLadDataset(jax_, transfer_dtype, assemble_chunk=24)
    assert len(res) == 80
    assert res.estimated_nbytes(port, transfer_dtype) == jres.estimated_nbytes(
        jax_, transfer_dtype) == 80 * 100 * 44 * (2 if transfer_dtype else 4)
    kw = dict(batch_size=16, seed=11)
    streamed = list(port.batches(**kw))
    for b, s, m in zip(res.batches(**kw), streamed, res.index_batches(**kw)):
        assert m["resident"] is res and b["inputs"].dtype == torch.float32
        np.testing.assert_array_equal(b["input_lens"].numpy(), s["input_lens"])
        np.testing.assert_array_equal(b["is_laugh"].numpy(), s["is_laugh"])
        if transfer_dtype is None:
            np.testing.assert_array_equal(b["inputs"].numpy(), s["inputs"])
        x, lens, labels = jres.gather(m["idx"])
        np.testing.assert_array_equal(b["inputs"].numpy(), np.asarray(x))
        np.testing.assert_array_equal(b["input_lens"].numpy(), np.asarray(lens))
        np.testing.assert_array_equal(b["is_laugh"].numpy(), np.asarray(labels))
    gathered = res.gather(torch.tensor([3, 3, 0]))[0]
    np.testing.assert_array_equal(gathered[0].numpy(), gathered[1].numpy())


def test_resident_refusals(corpus_cache):
    """The transfer dtype's check; a split sharded over processes holds its
    block of the zero-padded rows (the gather over the processes:
    tests/test_torch_distributed.py)."""
    with pytest.raises(ValueError, match="unknown transfer_dtype"):
        tds.resolve_transfer_dtype("bf16")
    assert tds.resolve_transfer_dtype(None) == (torch.float32, 4)
    port, _ = both(corpus_cache)
    whole = tds.ResidentLadDataset(port, device="cpu")
    n = len(whole)
    padded = tds.ResidentLadDataset(port, pad_rows_to=64, device="cpu")
    assert padded.feats.shape[0] == -(-n // 64) * 64 and len(padded) == n
    assert torch.equal(padded.feats[:n], whole.feats) and not padded.feats[n:].any()
    n_pad = -(-n // 3) * 3
    blocks = [tds.ResidentLadDataset(port, sharding=(r, 3), pad_rows_to=3, device="cpu")
              for r in range(3)]
    assert [(b.row_lo, b.row_hi) for b in blocks] == [
        (r * n_pad // 3, (r + 1) * n_pad // 3) for r in range(3)]
    held = torch.cat([b.feats for b in blocks])
    assert torch.equal(held[:n], whole.feats) and not held[n:].any()
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        tds.ResidentLadDataset(port, sharding=(0, 3), device="cpu")


def test_epoch_slices_are_jaxs():
    for args in ((80, 16, True, 3, False), (81, 16, True, 3, True), (5, 16, False, 0, False)):
        got, want = tds._epoch_slices(*args), jds._epoch_slices(*args)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
