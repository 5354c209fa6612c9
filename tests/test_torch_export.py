"""The port's model export (export.py, cli/export_model.py), its host prep
(host_prep.BucketGeometry, bucket_inputs) and cli/convert_checkpoint.py
against the JAX package's, on the CPU.

The window artifact (symbolic batch) is held against the live model (f32:
within 1e-6; bf16: within 2e-2 of the live bf16 copy) and against JAX's
``jax.export`` artifact on the same weights (f32 within 1e-5, bf16 within
2e-2).  The e2e artifact, run per bucket over ``bucket_inputs``, equals the
port's pipeline exactly and is within 1e-5 of JAX's e2e artifact.  On the
card, ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the artifact
to the live pipeline with the fbank kernel inside it.
"""

import threading

import numpy as np
import pytest
import torch

from laughter_detection_icsi_tpu import export as jexport
from laughter_detection_icsi_tpu import host_prep as jhp
from laughter_detection_icsi_tpu import inference as jinf
from laughter_detection_icsi_tpu.train import checkpoint as jckpt
from laughter_detection_icsi_tpu_torch import export as texport
from laughter_detection_icsi_tpu_torch import host_prep as thp
from laughter_detection_icsi_tpu_torch import inference as tinf
from laughter_detection_icsi_tpu_torch.cli import convert_checkpoint, export_model
from laughter_detection_icsi_tpu_torch.models import zoo
from laughter_detection_icsi_tpu_torch.train import Adam
from laughter_detection_icsi_tpu_torch.train import checkpoint as ckpt
from tests.fixtures.torch_weights import SMALL, both_models, few_torch_threads  # noqa: F401

SIZES = dict(chunk=128, bucket_frames=256)


@pytest.fixture(scope="module")
def models():
    return both_models("ResNetBigger", seed=5, **SMALL)


@pytest.fixture(scope="module")
def window_artifacts(models, tmp_path_factory):
    """Each precision's window artifact, saved and loaded back:
    (artifact, bytes, the exported program)."""
    root = tmp_path_factory.mktemp("export")
    out = {}
    for prec in ("float32", "bfloat16"):
        path = str(root / f"windows_{prec}.pt2")
        exported = texport.export_window_classifier(models[3], precision=prec, device="cpu")
        n = texport.save(exported, path)
        out[prec] = (texport.load(path), n, exported)
    return out


def _windows(b, seed=7):
    return (np.random.default_rng(seed).standard_normal((b, 1, 100, 44)) * 3).astype(np.float32)


@pytest.mark.parametrize("prec", ["float32", "bfloat16"])
def test_window_artifact_symbolic_batch_matches_live_and_jax(models, window_artifacts, prec):
    jmodel, params, state, tmodel = models
    art, n, _ = window_artifacts[prec]
    assert n > 1000 and art.precision == prec and art.device == torch.device("cpu")
    live = tinf.cast_model_bf16(tmodel) if prec == "bfloat16" else tmodel
    jart = jexport.export_window_classifier(jmodel, params, state, precision=prec)
    tol = 1e-5 if prec == "float32" else 2e-2
    for b in (1, 37):  # one artifact, two batch sizes
        x = _windows(b)
        got = art.call(x)
        assert got.dtype == torch.float32 and got.shape == (b,)
        with torch.no_grad():
            want = live(torch.from_numpy(x).to(next(live.parameters()).dtype)).float()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-6 if prec == "float32" else 2e-2)
        np.testing.assert_allclose(got.numpy(), np.asarray(jart.call(x)), rtol=0, atol=tol)
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())  # the caller's model


@pytest.mark.parametrize("wave_dtype", ["int16", "float32"])
def test_e2e_artifact_equals_pipeline_and_jax(models, tmp_path, wave_dtype):
    jmodel, params, state, tmodel = models
    pipe = tinf.LaughterPipeline(tmodel, settings=tinf.InferenceSettings(**SIZES), device="cpu")
    exported, wave_len = texport.export_bucket_pipeline(pipe, int16_in=wave_dtype == "int16")
    assert wave_len == pipe.wave_len == thp.bucket_wave_len(pipe.settings)
    path = str(tmp_path / "e2e.pt2")
    texport.save(exported, path)
    art = texport.load(path)
    jpipe = jinf.LaughterPipeline(jmodel, params, state, settings=jinf.InferenceSettings(**SIZES))
    jart, _ = jexport.export_bucket_pipeline(jpipe, int16_in=wave_dtype == "int16")
    rng = np.random.default_rng(3)
    wave = rng.standard_normal(16000 * 6 + 777) * 0.1
    wave = (wave * 32767).astype(np.int16) if wave_dtype == "int16" else wave.astype(np.float32)
    want = pipe.probs_for_waveform(wave)
    pieces, jpieces = [], []
    buckets = list(thp.bucket_inputs(wave, settings=pipe.settings))
    assert len(buckets) == 3  # the last one partial
    for buf, valid, n_out in buckets:
        assert buf.shape == (wave_len,) and buf.dtype == wave.dtype
        pieces.append(art.call(buf, valid)[:n_out].numpy())
        jpieces.append(np.asarray(jart.call(buf, valid))[:n_out])
    got = np.concatenate(pieces)
    assert np.array_equal(got, want)
    np.testing.assert_allclose(got, np.concatenate(jpieces), rtol=0, atol=1e-5)


def test_save_concurrent_same_path_publishes_intact_artifact(window_artifacts, tmp_path):
    """Writers to one path each write a tmp of their own; the published
    file is one whole save's, it loads, and no tmp is left behind (JAX
    tests/test_export.py's test of the same name)."""
    exported = window_artifacts["float32"][2]
    path = tmp_path / "race.pt2"
    errs, sizes = [], []
    start = threading.Barrier(4)  # the saves overlap from the first

    def worker():
        try:
            start.wait()
            for _ in range(2):
                sizes.append(texport.save(exported, str(path)))
        except BaseException as e:  # pragma: no cover - the failure path
            errs.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert path.stat().st_size in set(sizes)
    art = texport.load(str(path))
    assert art.call(np.zeros((4, 1, 100, 44), np.float32)).shape == (4,)
    assert [p.name for p in tmp_path.iterdir()] == [path.name]
    blob = path.read_bytes()
    assert texport.load_bytes(blob).precision == "float32"


def test_export_refuses_fused_conv_and_unknown_precision(models):
    pipe = tinf.LaughterPipeline(models[3], device="cpu",
                                 settings=tinf.InferenceSettings(**SIZES, mode="fused_conv"))
    with pytest.raises(ValueError, match="mode='windows'"):
        texport.export_bucket_pipeline(pipe)
    with pytest.raises(ValueError, match="unknown precision"):
        texport.export_window_classifier(models[3], precision="half", device="cpu")


def test_bucket_geometry_and_inputs_as_jax():
    g, s = thp.BucketGeometry(), tinf.InferenceSettings()
    assert (g.window, g.bucket_frames) == (s.window, s.bucket_frames)
    assert (g.window, g.bucket_frames) == (jhp.BucketGeometry().window,
                                           jhp.BucketGeometry().bucket_frames)
    assert texport.bucket_inputs is thp.bucket_inputs
    with pytest.raises(ValueError, match="bucket_frames must be >= 1"):
        thp.BucketGeometry(bucket_frames=0)
    with pytest.raises(ValueError, match="window must be >= 1"):
        thp.BucketGeometry(window=-1)
    with pytest.raises(ValueError, match="1-D PCM"):
        thp.bucket_inputs(np.zeros((100, 2), np.float32))  # at call time, no iteration
    with pytest.raises(TypeError, match="int16 or float32"):
        thp.bucket_inputs(np.zeros(10, np.int32))
    assert list(thp.bucket_inputs(np.zeros(0, np.int16))) == []
    rng = np.random.default_rng(11)
    geo = thp.BucketGeometry(bucket_frames=128)
    for wave in ((rng.standard_normal(16000 * 3) * 9000).astype(np.int16),
                 rng.standard_normal(16000).astype(np.float64)):
        got = list(thp.bucket_inputs(wave, settings=geo))
        want = list(jhp.bucket_inputs(wave, settings=jhp.BucketGeometry(bucket_frames=128)))
        assert len(got) == len(want) > 0
        for (b1, v1, n1), (b2, v2, n2) in zip(got, want):
            assert b1.dtype == b2.dtype and np.array_equal(b1, b2)
            assert (v1, n1) == (v2, n2) and v1.dtype == np.int32


def test_export_cli_writes_loadable_artifacts(tmp_path, capsys):
    out = str(tmp_path / "windows.pt2")
    assert export_model.main(["--random_init", "--what", "windows", "--batch", "4",
                              "--out", out, "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "wrote" in printed and "signature: [4, 1, 100, 44]" in printed
    probs = texport.load(out).call(np.zeros((4, 1, 100, 44), np.float32))
    assert probs.shape == (4,) and bool(((probs >= 0) & (probs <= 1)).all())
    out = str(tmp_path / "e2e.pt2")
    assert export_model.main(["--random_init", "--what", "e2e", "--chunk", "128",
                              "--bucket_frames", "256", "--wave_dtype", "float32",
                              "--precision", "bfloat16", "--out", out, "--device", "cpu"]) == 0
    art = texport.load(out)
    assert art.precision == "bfloat16"
    wave = (np.random.default_rng(2).standard_normal(16000 * 2) * 0.1).astype(np.float32)
    (buf, valid, n_out), = thp.bucket_inputs(wave, settings=thp.BucketGeometry(bucket_frames=256))
    probs = art.call(buf, valid)
    assert probs.shape == (256,) and probs.dtype == torch.float32
    assert bool(torch.isfinite(probs[:n_out]).all())


def test_export_cli_rejections(tmp_path):
    out = str(tmp_path / "x.pt2")
    main = export_model.main
    with pytest.raises(SystemExit, match="--model_path is required"):
        main(["--out", out, "--device", "cpu"])
    with pytest.raises(SystemExit, match="--chunk only applies"):
        main(["--random_init", "--what", "windows", "--chunk", "512", "--out", out])
    with pytest.raises(SystemExit, match="--wave_dtype only applies"):
        main(["--random_init", "--wave_dtype", "int16", "--out", out])
    with pytest.raises(SystemExit, match="--batch only applies"):
        main(["--random_init", "--what", "e2e", "--batch", "8", "--out", out])
    with pytest.raises(SystemExit, match="--chunk must be >= 1"):
        main(["--random_init", "--what", "e2e", "--chunk", "0", "--out", out])
    with pytest.raises(SystemExit, match="--batch must be >= 1"):
        main(["--random_init", "--batch", "-3", "--out", out])
    # Validation that needs only the arguments precedes the checkpoint load.
    with pytest.raises(SystemExit, match="--chunk only applies"):
        main(["--model_path", str(tmp_path / "missing"), "--what", "windows",
              "--chunk", "512", "--out", out])
    with pytest.raises(SystemExit):
        main(["--random_init", "--platforms", "cpu", "--out", out])  # XLA's flag: not here


def _mlp_checkpoint(directory, **counters):
    m = zoo.MLPModel(linear_layer_size=16, hid_dim1=8, hid_dim2=4)
    params = {k: p.detach() for k, p in m.named_parameters()}
    opt = Adam().init(params)
    return m, ckpt.save_checkpoint(str(directory), m.state_dict(), opt_state=opt, **counters)


def test_convert_checkpoint_roundtrip(tmp_path):
    m, native = _mlp_checkpoint(tmp_path, epoch=3, global_step=77, best_val_loss=0.4)
    pth = str(tmp_path / "out.pth.tar")
    assert convert_checkpoint.main([native, pth]) == 0
    back = str(tmp_path / "back.ckpt.npz")
    assert convert_checkpoint.main([pth, back]) == 0
    loaded = ckpt.load_checkpoint(back)
    assert (loaded["epoch"], loaded["global_step"]) == (3, 77)
    want = m.state_dict()
    assert set(loaded["state_dict"]) == set(want)
    for k, v in loaded["state_dict"].items():
        assert torch.equal(v, want[k]), k
    # The JAX package reads both converted files.
    for path in (pth, back):
        jparams = jckpt.load_checkpoint(path)["params"]
        for k, v in jckpt.flatten_tree(jparams).items():
            np.testing.assert_array_equal(np.asarray(v), want[k].numpy())


def test_convert_does_not_clobber_live_checkpoint(tmp_path):
    """Converting into a directory that holds a live training checkpoint
    leaves its last.ckpt.npz as it was, and a mid-epoch ``epoch_step``
    survives the conversion (JAX tests/test_utils_and_convert.py:63)."""
    _, live = _mlp_checkpoint(tmp_path, epoch=9, global_step=900, epoch_step=17)
    live_bytes = open(live, "rb").read()
    _, src = _mlp_checkpoint(tmp_path / "src", epoch=1, global_step=5, epoch_step=3)
    dest = str(tmp_path / "converted.ckpt.npz")
    assert convert_checkpoint.main([src, dest]) == 0
    assert open(live, "rb").read() == live_bytes
    loaded = ckpt.load_checkpoint(dest)
    assert (loaded["global_step"], loaded["epoch_step"]) == (5, 3)
    assert loaded["opt_state"] is not None and int(loaded["opt_state"].step) == 0
