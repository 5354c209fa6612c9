"""The port on the card: the fbank kernel against its plain version (the
44-bin features and AST's 128-bin ones), the pipeline's launch count, the
packed codec's device decoder, and AST's clips mode in bfloat16 against
float32.  Marked ``cuda``; each test skips without a
card.  This file imports neither JAX nor the JAX package, so it runs on a
machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import dataclasses
import hashlib
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from laughter_detection_icsi_tpu_torch import host_prep, inference
from laughter_detection_icsi_tpu_torch.config import AST_FEAT, FEAT
from laughter_detection_icsi_tpu_torch.models import zoo
from laughter_detection_icsi_tpu_torch.ops import fbank as tfb
from laughter_detection_icsi_tpu_torch.ops import fbank_cuda

TOL = dict(atol=2e-4, rtol=1e-4)  # tests/test_fbank_pallas.py's feature tolerance


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _wave(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [16000, 48777, 399, 80, (2 * 256 + 37) * 160, (3, 16777)])
def test_kernel_matches_plain(card, shape):
    x = torch.from_numpy(_wave(shape)).to(card)
    before = fbank_cuda.launches
    with inference.strict_fp32():
        got = fbank_cuda.fbank_cuda(x, FEAT)
        want = tfb.fbank(x, FEAT)
    assert fbank_cuda.launches == before + 1
    torch.testing.assert_close(got, want, **TOL)
    if x.ndim == 2:  # batch rows are computed exactly as each row alone
        for c in range(x.shape[0]):
            assert torch.equal(got[c], fbank_cuda.fbank_cuda(x[c].contiguous(), FEAT))


def _edge_wave(kind):
    if kind == "int16-scaled":
        pcm = np.clip(_wave(48777, seed=1) * 3 * 32768, -32768, 32767).astype(np.int16)
        return pcm / np.float32(32768)
    if kind == "silent stretch":
        w = _wave(32000, seed=2)
        w[6000:22000] = 0.0  # whole frames of silence: power at the floor
        return w
    frames = 3 * fbank_cuda.frames_per_block() + (kind == "48k+1 frames")
    return _wave(frames * FEAT.frame_shift_samples, seed=3)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int16-scaled", "silent stretch", "48k frames", "48k+1 frames"])
def test_kernel_matches_plain_on_edge_inputs(card, kind):
    x = torch.from_numpy(_edge_wave(kind)).to(card)
    with inference.strict_fp32():
        got = fbank_cuda.fbank_cuda(x, FEAT)
        want = tfb.fbank(x, FEAT)
    torch.testing.assert_close(got, want, **TOL)
    if kind.startswith("48k"):
        assert got.shape[0] % fbank_cuda.frames_per_block() == (kind == "48k+1 frames")
    if kind == "silent stretch":
        floor = torch.full_like(got, float(np.log(FEAT.energy_floor)))
        assert torch.isclose(got, floor, rtol=0, atol=1e-5).any()


@pytest.mark.cuda
def test_kernel_other_frame_geometry(card):
    # 21 ms frames (336 samples): another basis depth and wave-tile height.
    cfg = dataclasses.replace(FEAT, frame_length=0.021)
    fbank_cuda.check_config(cfg)
    x = torch.from_numpy(_wave(16123, seed=4)).to(card)
    with inference.strict_fp32():
        got = fbank_cuda.fbank_cuda(x, cfg)
        want = tfb.fbank(x, cfg)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
def test_kernel_main_path_bucket(card):
    cfg = host_prep.snip_cfg(FEAT)
    x = torch.from_numpy(_wave(host_prep.bucket_wave_len(inference.InferenceSettings()))).to(card)
    with inference.strict_fp32():
        got = fbank_cuda.fbank_cuda(x, cfg)
        want = tfb.fbank(x, cfg)
    assert got.shape == (6243, FEAT.num_filters)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(card):
    with pytest.raises(TypeError, match="float32"):
        fbank_cuda.fbank_cuda(torch.zeros(16000, dtype=torch.float64, device=card))
    with pytest.raises(ValueError, match="contiguous"):
        fbank_cuda.fbank_cuda(torch.zeros(2, 16000, device=card)[:, ::2])


@pytest.mark.cuda
def test_pipeline_launches_once_per_bucket(card):
    model = zoo.build("ResNetBigger", linear_layer_size=24, filter_sizes=(8, 8, 8, 8))
    settings = inference.InferenceSettings(chunk=128, bucket_frames=256)
    pipe = inference.LaughterPipeline(model, settings=settings)  # device None = cuda
    wave = (_wave(16000 * 6 + 777) * 32767 / 4).astype(np.int16)
    before = fbank_cuda.launches
    probs = pipe.probs_for_waveform(wave)
    assert fbank_cuda.launches - before == 3
    cpu = inference.LaughterPipeline(model, settings=settings, device="cpu")
    np.testing.assert_allclose(probs, cpu.probs_for_waveform(wave), rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(inference.track_wave_len(18_432),), (4, 999_120)],
                         ids=["fused_conv whole track", "multichannel bucket batch"])
def test_kernel_matches_plain_at_serving_shapes(card, shape):
    # fused_conv's whole track for 150 s (18,432 frames, one launch) and a
    # [4, bucket] multichannel bucket batch (one launch per batch).
    cfg = host_prep.snip_cfg(FEAT)
    x = torch.from_numpy(_wave(shape, seed=5)).to(card)
    with inference.strict_fp32():
        got = fbank_cuda.fbank_cuda(x, cfg)
        want = tfb.fbank(x, cfg)
    assert got.shape[-2] == (18_432 if len(shape) == 1 else 6243)
    torch.testing.assert_close(got, want, **TOL)
    if x.ndim == 2:
        for c in range(x.shape[0]):
            assert torch.equal(got[c], fbank_cuda.fbank_cuda(x[c].contiguous(), cfg))


def _small_model():
    return zoo.build("ResNetBigger", linear_layer_size=24, filter_sizes=(8, 8, 8, 8))


@pytest.mark.cuda
def test_fully_conv_blocked_matches_whole_track(card):
    from laughter_detection_icsi_tpu_torch.models import fully_conv

    model = _small_model().to(card)
    feats = torch.from_numpy(_wave((2500, FEAT.num_filters), seed=6) * 5).to(card)
    with torch.inference_mode(), inference.strict_fp32():
        whole = fully_conv.fully_conv_probs(model, feats)
        blocked = fully_conv.fully_conv_probs_blocked(model, feats)
        grouped = fully_conv.fully_conv_probs_blocked(model, feats, block=256, max_blocks=3)
    torch.testing.assert_close(blocked, whole, rtol=0, atol=1e-5)
    torch.testing.assert_close(grouped, whole, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_streaming_equals_offline(card):
    settings = inference.InferenceSettings(chunk=128, bucket_frames=256)
    pipe = inference.LaughterPipeline(_small_model(), settings=settings)
    wave = (_wave(16000 * 20, seed=7) * 32767 / 4).astype(np.int16)
    sess = inference.StreamingSession(pipe)
    outs = [sess.feed(wave[lo : lo + 4000]) for lo in range(0, len(wave), 4000)]
    got = np.concatenate(outs + [sess.finish()])
    np.testing.assert_array_equal(got, pipe.probs_for_waveform(wave))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["auto", "delta"])
def test_unpack_pcm_on_the_card(card, mode):
    # Speech-like deltas, full-scale alternation (17-bit deltas) and silent
    # blocks: the decoder on the card gives the packed int16 values.
    from laughter_detection_icsi_tpu_torch.ops import pcm_pack

    x = (_wave(999_120, seed=8) * 32767 / 3).astype(np.int16)
    x[40_000:44_096] = np.where(np.arange(4096) % 2, 32767, -32768)
    x[100_000:200_000] = 0
    packed = pcm_pack.pack_pcm(x, mode=mode)
    wire = pcm_pack.widen(pcm_pack.wire_tensor(packed.wire()).to(card))
    widths, words = pcm_pack.split_wire(wire, len(packed.widths))
    got = pcm_pack.unpack_pcm(words, widths, packed.n, packed.delta)
    assert got.device.type == "cuda" and got.dtype == torch.int32
    np.testing.assert_array_equal(got.cpu().numpy(), x)


@pytest.mark.cuda
def test_packed_codec_equals_raw(card):
    from laughter_detection_icsi_tpu_torch.parallel import ShardedPipeline

    model = _small_model()  # one set of weights for both codecs
    wave = (_wave(16000 * 6 + 777, seed=9) * 32767 / 4).astype(np.int16)
    for cls, run in ((inference.LaughterPipeline, lambda p: [p.probs_for_waveform(wave)]),
                     (ShardedPipeline, lambda p: p.probs_for_waveforms([wave, wave[:50_000]]))):
        raw, packed = (
            run(cls(model, settings=inference.InferenceSettings(
                chunk=128, bucket_frames=256, transfer_codec=codec)))
            for codec in ("raw", "packed")
        )
        for a, b in zip(raw, packed):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(card):
    """One train step of a narrow ResNetBigger at dropout 0: loss and
    gradients on the card against the port on the CPU; the card's Adam
    update against the CPU's Adam applied to the card's gradients (Adam's
    first step is sign-like, so near-zero gradients would turn the
    devices' fp differences into lr-sized parameter differences)."""
    from laughter_detection_icsi_tpu_torch.train import Adam, Trainer

    rng = np.random.default_rng(4)
    batch = {"inputs": (rng.standard_normal((8, 100, 44)) * 0.5).astype(np.float32),
             "is_laugh": (rng.uniform(size=8) > 0.5).astype(np.float32)}

    def trainer(device):
        m = zoo.reference_init(zoo.build("ResNetBigger", dropout_rate=0.0, linear_layer_size=24,
                                         filter_sizes=(8, 8, 8, 8)), seed=3)
        return Trainer(m, device=device)

    gpu, cpu = trainer(card), trainer("cpu")
    loss_g, _, g_g = gpu.loss_and_grads(*gpu._prep(batch))
    loss_c, _, g_c = cpu.loss_and_grads(*cpu._prep(batch))
    assert abs(loss_g.item() - loss_c.item()) <= 1e-5
    for k in g_c:
        torch.testing.assert_close(g_g[k].cpu(), g_c[k], atol=1e-4, rtol=0)
    before = {k: p.detach().cpu().clone() for k, p in gpu.params.items()}
    opt = gpu.optimizer.update(g_g, gpu.init(), gpu.params)
    Adam().update({k: g.cpu() for k, g in g_g.items()}, Adam().init(before), before)
    assert int(opt.step) == 1
    for k, p in gpu.params.items():
        torch.testing.assert_close(p.detach().cpu(), before[k], atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_native_decoder_on_the_cards_machine(card, tmp_path):
    """The card's machine builds the native runtime (its CUDA toolkit
    brings a host compiler): shorten decodes there natively, equal to the
    numpy decoder."""
    from laughter_detection_icsi_tpu_torch.data import audio, shorten
    from laughter_detection_icsi_tpu_torch.runtime import native

    assert native.available()
    pcm = (np.cumsum(np.random.default_rng(6).standard_normal(32000)) * 50).astype(np.int16)
    path = str(tmp_path / "s.sph")
    audio.write_sphere_shorten(path, pcm, 16000)
    meta = audio.info(path)
    got = native.decode_shorten(path, meta.num_samples, meta.num_channels)
    np.testing.assert_array_equal(got[:, 0], pcm)
    np.testing.assert_array_equal(
        got, shorten.decode_file(path, meta.data_offset, max_frames=meta.num_samples))


@pytest.mark.cuda
def test_cached_track_from_the_kernel_matches_plain(card, tmp_path):
    """The feature cache featurizes on the card one kernel launch a bucket
    (two full 30,000-frame buckets and a partial one), within the feature
    tolerance of the plain featurizer on the same PCM."""
    from laughter_detection_icsi_tpu_torch.data import feature_cache

    wave = _wave(160 * 70_000 + 77, seed=8)
    cache = feature_cache.FeatureCache(str(tmp_path / "feats"))
    before = fbank_cuda.launches
    got = cache.add_track("Bmr021", "chan0", wave)  # device None = cuda
    assert fbank_cuda.launches - before == 3
    want = feature_cache.compute_track_features(wave, FEAT, device="cpu")
    assert got.shape == want.shape == (70_000, FEAT.num_filters)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(cache.track("Bmr021", "chan0"), got)


@pytest.mark.cuda
@pytest.mark.parametrize("transfer_dtype", [None, "bfloat16"])
def test_resident_gather_on_the_card(card, tmp_path, transfer_dtype):
    """The resident split lives on the card; a gather there equals the host
    assembly of the same rows (bfloat16: its rounding on the host)."""
    from laughter_detection_icsi_tpu_torch.data import dataset, feature_cache

    cache = feature_cache.FeatureCache(str(tmp_path / "feats"))
    cache.add_track("Bmr021", "chan0", _wave(16000 * 20, seed=9), device="cpu")
    r = np.random.default_rng(3)
    rows = [dict(meeting_id="Bmr021", chan_id="chan0", sub_start=round(float(s), 2),
                 sub_duration=0.5 if i % 5 == 0 else 1.0, label=i % 2)
            for i, s in enumerate(r.uniform(0, 19.5, 300))]
    ds = dataset.LadDataset(rows, cache)
    res = dataset.ResidentLadDataset(ds, transfer_dtype)  # device None = cuda
    assert res.feats.is_cuda
    idx = np.array([5, 299, 0, 5, 17])
    x, lens, labels = res.gather(idx)
    assert x.is_cuda and x.dtype == torch.float32
    host = ds._assemble(idx)
    want = torch.from_numpy(host["inputs"])
    if transfer_dtype:
        want = want.bfloat16().float()
    assert torch.equal(x.cpu(), want)
    assert torch.equal(lens.cpu(), torch.from_numpy(host["input_lens"]))
    assert torch.equal(labels.cpu(), torch.from_numpy(host["is_laugh"]))


@pytest.mark.cuda
def test_custom_op_on_the_card_and_its_fake(card):
    """``torch.ops.laughter_icsi_torch.fbank`` launches the kernel on a CUDA
    tensor (within the feature tolerance of the plain version), and its
    fake gives the real output's shape and dtype."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = host_prep.snip_cfg(FEAT)
    x = torch.from_numpy(_wave((2, 48_777), seed=10)).to(card)
    before = fbank_cuda.launches
    with inference.strict_fp32():
        got = torch.ops.laughter_icsi_torch.fbank(x, *fbank_cuda.op_args(cfg))
        want = tfb.fbank(x, cfg)
    assert fbank_cuda.launches - before == 1
    torch.testing.assert_close(got, want, **TOL)
    with FakeTensorMode() as mode:
        fake = torch.ops.laughter_icsi_torch.fbank(mode.from_tensor(x), *fbank_cuda.op_args(cfg))
    assert fake.shape == got.shape and fake.dtype == got.dtype == torch.float32
    torch.library.opcheck(torch.ops.laughter_icsi_torch.fbank.default,
                          (x, *fbank_cuda.op_args(cfg)))


@pytest.mark.cuda
def test_bf16_pipeline_on_the_card(card):
    """A bf16 pipeline on the card: one launch a bucket, within 0.05 of the
    float32 pipeline and within 2e-2 of the bf16 pipeline on the CPU."""
    model = _small_model()
    wave = (_wave(16000 * 6 + 777, seed=11) * 32767 / 4).astype(np.int16)
    run = {}
    for prec, dev in (("bfloat16", card), ("float32", card), ("bfloat16", "cpu")):
        settings = inference.InferenceSettings(chunk=128, bucket_frames=256, precision=prec)
        before = fbank_cuda.launches
        run[prec, str(dev)] = inference.LaughterPipeline(
            model, settings=settings, device=dev).probs_for_waveform(wave)
        if dev == card:
            assert fbank_cuda.launches - before == 3
    bf = run["bfloat16", "cuda"]
    assert bf.dtype == np.float32 and np.isfinite(bf).all()
    np.testing.assert_allclose(bf, run["float32", "cuda"], rtol=0, atol=0.05)
    np.testing.assert_allclose(bf, run["bfloat16", "cpu"], rtol=0, atol=2e-2)


@pytest.mark.cuda
def test_e2e_artifact_equals_the_live_pipeline_on_the_card(card, tmp_path):
    """The e2e artifact exported on the card launches the kernel once a
    bucket and gives the live pipeline's probabilities (the same ops at the
    same shapes: equal, held within 1e-6 in case the program's graph runs
    an op by another kernel)."""
    from laughter_detection_icsi_tpu_torch import export

    pipe = inference.LaughterPipeline(
        _small_model(), settings=inference.InferenceSettings(chunk=128, bucket_frames=256))
    path = str(tmp_path / "e2e.pt2")
    export.save(export.export_bucket_pipeline(pipe)[0], path)
    art = export.load(path)
    wave = (_wave(16000 * 6 + 777, seed=12) * 32767 / 4).astype(np.int16)
    before = fbank_cuda.launches
    got = torch.cat([art.call(buf, valid)[:n] for buf, valid, n in
                     host_prep.bucket_inputs(wave, settings=pipe.settings)])
    assert fbank_cuda.launches - before == 3 and got.is_cuda
    np.testing.assert_allclose(got.cpu().numpy(), pipe.probs_for_waveform(wave), rtol=0,
                               atol=1e-6)


@pytest.mark.cuda
def test_hard_block_waits_for_a_long_kernel(card):
    """``hard_block`` behind ~0.5 s of device work returns the sum the
    work produced: it cannot return before the device ran."""
    from laughter_detection_icsi_tpu_torch.utils import timing

    x = torch.ones(4096, 4096, device=card)
    torch.cuda.synchronize()
    torch.cuda._sleep(10**9)  # the product waits behind it on the stream
    y = x @ x  # every element 4096
    t0 = time.perf_counter()
    got = timing.hard_block({"y": y, "x": [x]})
    waited = time.perf_counter() - t0
    want = 4096.0**3 + 4096.0**2
    assert got == pytest.approx(want, rel=1e-6), (got, want, y.double().sum().item())
    assert waited > 0.1, waited


def _sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                          "-i", "0"], capture_output=True, text=True, timeout=30)
    return float(out.stdout.split()[0])


@pytest.mark.cuda
def test_cuda_ms_times_the_device(card):
    """``cuda_ms`` of ``torch.cuda._sleep(cycles)`` within 20% of the
    cycles at the SM clock nvidia-smi reads while the card spins."""
    from laughter_detection_icsi_tpu_torch.utils import timing

    cycles = 10**7
    torch.cuda._sleep(4 * 10**9)  # ~2 s of spinning: the clock under load
    time.sleep(0.5)
    mhz = _sm_clock_mhz()
    torch.cuda.synchronize()
    got = timing.cuda_ms(lambda: torch.cuda._sleep(cycles), iters=20)
    want = cycles / (mhz * 1e3)
    assert abs(got - want) <= 0.2 * want, (got, want, mhz)


# --------------------------------------------------------------------------- #
# The conv epilogue (ops/bn_act_cuda.py)
# --------------------------------------------------------------------------- #

#: The sweep cell's conv outputs (stem 64, filter_sizes (64, 32, 16, 16),
#: 44 mel bins, bucket 6144): a window-edge band, the whole-track stem and
#: the strided tail's stage 3.
EPILOGUE_SHAPES = {"band": (6144, 64, 7, 44), "track": (1, 64, 6243, 44),
                   "tail": (6144, 16, 25, 11)}
#: Each call site's form: (conv bias, BatchNorm, residual, ReLU).
EPILOGUE_FORMS = {
    "stem: no bias, BN, ReLU": (False, True, None, True),
    "conv1: bias, BN, ReLU": (True, True, None, True),
    "shortcut: no bias, BN": (False, True, None, False),
    "conv2: bias, BN, contiguous residual, ReLU": (True, True, "contiguous", True),
    "band conv2: bias, BN, strided residual, ReLU": (True, True, "strided", True),
    "no BN: bias, strided residual, ReLU": (True, False, "strided", True),
}


def _bn(c, gen, dtype, card):
    bn = torch.nn.BatchNorm2d(c)
    with torch.no_grad():
        bn.weight.uniform_(0.7, 1.3, generator=gen)
        bn.bias.normal_(0.0, 0.1, generator=gen)
        bn.running_mean.normal_(0.0, 0.3, generator=gen)
        bn.running_var.uniform_(0.5, 2.0, generator=gen)
    return bn.to(card, dtype).eval()


def _composed(x, conv, bn, train=False, relu=True, residual=None, **kw):
    """``layers.conv_bn_act``'s plain version, on whatever device ``x``
    is: the chain of eager ops the kernel replaces."""
    from laughter_detection_icsi_tpu_torch.models import layers as L

    y = L.batch_norm(L.conv2d(x, conv, **kw), bn, train)
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("where", list(EPILOGUE_SHAPES))
@pytest.mark.parametrize("form", list(EPILOGUE_FORMS))
def test_conv_bn_act_equals_the_composed_chain_bit_for_bit(card, dtype, where, form):
    """``layers.conv_bn_act`` on the card (cuDNN's conv, then one launch of
    the epilogue) gives the composed chain's bits on the card, at the sweep
    cell's shapes, in bf16 and float32."""
    from laughter_detection_icsi_tpu_torch.models import layers as L
    from laughter_detection_icsi_tpu_torch.ops import bn_act_cuda

    has_bias, has_bn, residual, relu = EPILOGUE_FORMS[form]
    n, c, h, w = EPILOGUE_SHAPES[where]
    gen = torch.Generator().manual_seed(7)
    conv = torch.nn.Conv2d(c, c, 3, bias=has_bias)
    with torch.no_grad():
        for p in conv.parameters():
            p.uniform_(-0.05, 0.05, generator=gen)
    conv = conv.to(card, dtype)
    bn = _bn(c, gen, dtype, card) if has_bn else None
    x = torch.randn((n, c, h, w), generator=gen).to(card, dtype)
    res = None
    if residual == "contiguous":
        res = torch.randn((n, c, h, w), generator=gen).to(card, dtype)
    elif residual == "strided":  # shared_stem's crop(x, 2) of a taller band
        res = torch.randn((n, c, h + 2, w), generator=gen).to(card, dtype)[:, :, 2:]
    with torch.inference_mode(), inference.strict_fp32():
        before = bn_act_cuda.launches
        got = L.conv_bn_act(x, conv, bn, relu=relu, residual=res)
        assert bn_act_cuda.launches - before == 1
        want = _composed(x, conv, bn, relu=relu, residual=res)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_bn_act_op_on_special_values_and_odd_layouts(card, dtype):
    """The op alone against the eager chain on the card: NaN, infinities
    and signed zeros in ``y``, a plane size that is no multiple of the
    16-byte vector (the ragged end), a ``y`` off 16-byte alignment (the
    scalar path) and a zero-variance channel; the op's fake and
    ``torch.library.opcheck``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from laughter_detection_icsi_tpu_torch.ops import bn_act_cuda  # noqa: F401

    gen = torch.Generator().manual_seed(8)
    c = 5
    bn = _bn(c, gen, dtype, card)
    with torch.no_grad():
        bn.running_var[2] = 0.0
    bias = torch.randn(c, generator=gen).to(card, dtype)
    base = torch.randn(3 * c * 7 * 9 + 1, generator=gen).to(card, dtype)
    base[:8] = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0, -0.0, 1e-30,
                             -1e-30, 3.0])
    for y in (base[:-1].view(3, c, 7, 9), base[1:].view(3, c, 7, 9)):  # aligned, then not
        res = torch.randn((3, c, 9, 9), generator=gen).to(card, dtype)[:, :, 1:-1]
        args = (y, bias, bn.weight, bn.bias, bn.running_mean, bn.running_var, res, True,
                1e-5)
        got = torch.ops.laughter_icsi_torch.bn_act(*args)
        inv = torch.rsqrt((bn.running_var + 1e-5).float()).to(dtype)
        shape = (1, -1, 1, 1)
        want = y + bias.reshape(shape)
        want = (want - bn.running_mean.reshape(shape)) * (bn.weight * inv).reshape(shape)
        want = torch.relu(want + bn.bias.reshape(shape) + res)
        assert torch.equal(_bits(got), _bits(want)), (got - want).abs().max()
    with FakeTensorMode() as mode:
        fake = torch.ops.laughter_icsi_torch.bn_act(
            *(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    assert fake.shape == got.shape and fake.dtype == got.dtype
    # The op has no autograd formula (eval only): check it on tensors that
    # need no gradient.
    args = tuple(a.detach() if isinstance(a, torch.Tensor) else a for a in args)
    torch.library.opcheck(torch.ops.laughter_icsi_torch.bn_act.default, args)


@pytest.mark.cuda
def test_bn_act_refuses_what_it_does_not_take(card):
    y = torch.zeros((2, 3, 4, 5), device=card)
    op = torch.ops.laughter_icsi_torch.bn_act
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        op(y.half(), None, None, None, None, None, None, True, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        op(y.transpose(2, 3), None, None, None, None, None, None, True, 1e-5)
    with pytest.raises(ValueError, match="together"):
        op(y, None, torch.ones(3, device=card), None, None, None, None, True, 1e-5)
    with pytest.raises(ValueError, match="residual"):
        op(y, None, None, None, None, None, y[:, :, :3], True, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_eval_after_a_train_step_matches_the_composed_chain(card, dtype, monkeypatch):
    """Eval, a train-mode forward (BatchNorm's running statistics move in
    place), eval again: each eval forward through the kernel equals the
    composed chain's on the card, so no per-channel term outlives the
    statistics it came from.  The train forward launches nothing."""
    from laughter_detection_icsi_tpu_torch.models import layers as L
    from laughter_detection_icsi_tpu_torch.ops import bn_act_cuda

    model = zoo.build("ResNetBigger", dropout_rate=0.0, linear_layer_size=48).to(card, dtype)
    x = torch.from_numpy(_wave((16, 1, 100, 44), seed=13) * 10).to(card, dtype)

    def both():
        with torch.no_grad(), inference.strict_fp32():
            fused = model.eval()(x)
            with monkeypatch.context() as m:
                m.setattr(L, "conv_bn_act", _composed)
                plain = model(x)
        return fused, plain

    first = both()
    before = bn_act_cuda.launches
    with torch.no_grad(), inference.strict_fp32():
        model.train()(x)
    assert bn_act_cuda.launches == before
    second = both()
    for fused, plain in (first, second):
        assert torch.equal(_bits(fused), _bits(plain))
    assert not torch.equal(first[0], second[0])  # the statistics did move


@pytest.mark.cuda
def test_classify_bucket_launches_the_epilogue_once_a_conv(card):
    """The preset's bf16 classify step with stage-2 sharing, one chunk a
    bucket: 40 launches (stem and stage 1 over the track 5, stage 2 over
    the track 5, two edge bands of 5 + 5 convs, stages 3-4 of the strided
    tail 10), equal to the composed chain's bits; the same naive window
    batch in train mode launches none."""
    from laughter_detection_icsi_tpu_torch.models import layers as L
    from laughter_detection_icsi_tpu_torch.ops import bn_act_cuda

    model = inference.cast_model_bf16(zoo.build("ResNetBigger", linear_layer_size=48)).to(card)
    settings = inference.InferenceSettings(chunk=256, bucket_frames=256, precision="bfloat16")
    feats = torch.from_numpy(_wave((256 + 99, 44), seed=14) * 10).to(card)
    with torch.inference_mode():
        before = bn_act_cuda.launches
        got = inference.classify_bucket(model, feats, 300, settings, use_shared_stem=True)
        assert bn_act_cuda.launches - before == 40
        with pytest.MonkeyPatch.context() as m:
            m.setattr(L, "conv_bn_act", _composed)
            want = inference.classify_bucket(model, feats, 300, settings, use_shared_stem=True)
        assert torch.equal(got, want)
        model.dropout_rate = 0.0
        model.train()
        before = bn_act_cuda.launches
        inference.classify_bucket(model, feats, 300, settings, use_shared_stem=False)
        assert bn_act_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("precision,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_shared_stem_matches_naive_windows_with_the_epilogue(card, precision, atol):
    """The preset-width pipeline on the card through the epilogue: the
    shared stem within chip_smoke's 1e-5 of the naive window batch in
    float32 (test_torch_precision's 2e-2 in bf16)."""
    model = zoo.build("ResNetBigger", linear_layer_size=48)
    wave = (_wave(16000 * 6 + 777, seed=15) * 32767 / 4).astype(np.int16)
    run = {}
    for shared in (None, False):
        settings = inference.InferenceSettings(chunk=128, bucket_frames=256, precision=precision,
                                               shared_stem=shared)
        run[shared] = inference.LaughterPipeline(model, settings=settings,
                                                 device=card).probs_for_waveform(wave)
    np.testing.assert_allclose(run[None], run[False], rtol=0, atol=atol)


# --------------------------------------------------------------------------- #
# AST's features and clips mode (the ast_audioset preset)
# --------------------------------------------------------------------------- #

#: The clips cell's limit on the mean logit gap against its reference.
CLIPS_CELL = json.loads((Path(__file__).resolve().parent.parent / "benchmark" / "workloads"
                         / "ast_audioset_bf16.clips_6ch_600s.json").read_text())

#: SHA-256 of the 44-bin features of ``_wave((4, 999_120), seed=5)`` (a
#: [4, bucket] batch, snip_edges framing) from the kernel as it stood before
#: the 128-bin launches were added (NVIDIA H100 80GB HBM3).
FBANK_44_DIGEST = "d868e74233e37283841affa07641edb506f30cc517fe0e3847294c17aeb8158d"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [16000 * 12 + 77, (6, 6923 * 160 + 400)],
                         ids=["a 12 s track", "the clips cell's bucket batch"])
def test_kernel_matches_plain_at_ast_features(card, shape):
    x = torch.from_numpy(_wave(shape, seed=7)).to(card)
    with inference.strict_fp32():
        got = fbank_cuda.fbank_cuda(x, AST_FEAT)
        want = tfb.fbank(x, AST_FEAT)
    assert got.shape[-1] == 128 and got.shape[-2] == host_prep.num_frames(x.shape[-1], AST_FEAT)
    torch.testing.assert_close(got, want, **TOL)
    if x.ndim == 2:
        assert got.shape[-2] == 6924
        for c in range(x.shape[0]):
            assert torch.equal(got[c], fbank_cuda.fbank_cuda(x[c].contiguous(), AST_FEAT))


@pytest.mark.cuda
def test_the_44_bin_launch_gives_the_bits_it_gave(card):
    x = torch.from_numpy(_wave((4, 999_120), seed=5)).to(card)
    with inference.strict_fp32():
        got = fbank_cuda.fbank_cuda(x, host_prep.snip_cfg(FEAT))
    digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
    assert digest == FBANK_44_DIGEST, digest


@pytest.mark.cuda
def test_clips_mode_bf16_within_the_cells_limit_of_float32(card):
    from laughter_detection_icsi_tpu_torch.parallel import ShardedPipeline

    model = zoo.build("AST", dropout_rate=0.0, linear_layer_size=768, filter_sizes=(), seed=5)
    waves = [(_wave(16000 * s, seed=s) * 32767 / 3).astype(np.int16) for s in (25, 7)]
    logits, probs = {}, {}
    for precision in ("float32", "bfloat16"):
        settings = inference.InferenceSettings(mode="clips", bucket_frames=1000, clip_batch=16,
                                               precision=precision)
        pipe = ShardedPipeline(model, feat_cfg=AST_FEAT, settings=settings, device=card)
        pipe.logit_sink = []
        before = fbank_cuda.launches
        probs[precision], ts = pipe.probs_for_waveforms_device(waves)
        assert fbank_cuda.launches - before == 3  # one a bucket batch of 1,000 frames
        logits[precision] = torch.cat(pipe.logit_sink, dim=1).float()
    assert ts == [2498, 698] and logits["float32"].shape == (2, 30, 527)
    gap = float((logits["bfloat16"] - logits["float32"]).abs().mean())
    assert gap < CLIPS_CELL["limits"]["logit_gap_mean"], gap
    torch.testing.assert_close(probs["bfloat16"], probs["float32"], atol=0.05, rtol=0)
