"""``layers.conv_bn_act`` on the CPU: its composed chain is, bit for bit,
the inline expressions each call site of the zoo and the shared stem
wrote before the epilogue kernel existed, in bf16 and float32; and the
kernel's custom op exports with its fake.  The kernel itself runs on the
card only (tests/test_torch_cuda.py holds it against this chain there).
"""

import copy

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from laughter_detection_icsi_tpu_torch.models import layers as L
from laughter_detection_icsi_tpu_torch.ops import bn_act_cuda


def _modules(cin, cout, k, bias, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    conv = nn.Conv2d(cin, cout, k, bias=bias)
    bn = nn.BatchNorm2d(cout)
    with torch.no_grad():
        for p in conv.parameters():
            p.uniform_(-0.3, 0.3, generator=gen)
        bn.weight.uniform_(0.7, 1.3, generator=gen)
        bn.bias.normal_(0.0, 0.1, generator=gen)
        bn.running_mean.normal_(0.0, 0.3, generator=gen)
        bn.running_var.uniform_(0.5, 2.0, generator=gen)
    return conv.to(dtype), bn.to(dtype).eval()


def _x(shape, dtype, seed):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(dtype)


def _crop(v, n):
    return v[:, :, n:]


# Each form: (conv in, out, kernel, bias) and a pair of functions of
# (x, conv, bn, train) -> (the inline expression, the conv_bn_act call).
FORMS = {
    "zoo stem": ((1, 8, 3, False), (
        lambda x, c, b, t: torch.relu(L.batch_norm(L.conv2d(x, c, 1, 1), b, t)),
        lambda x, c, b, t: L.conv_bn_act(x, c, b, t))),
    "block conv1, stride 2": ((8, 8, 3, True), (
        lambda x, c, b, t: torch.relu(L.batch_norm(L.conv2d(x, c, stride=2, padding=1), b, t)),
        lambda x, c, b, t: L.conv_bn_act(x, c, b, t, stride=2))),
    "block conv2 + identity": ((8, 8, 3, True), (
        lambda x, c, b, t: torch.relu(
            L.batch_norm(L.conv2d(x, c, stride=1, padding=1), b, t) + x),
        lambda x, c, b, t: L.conv_bn_act(x, c, b, t, residual=x))),
    "shortcut, 1x1 stride 2": ((8, 8, 1, False), (
        lambda x, c, b, t: L.batch_norm(L.conv2d(x, c, stride=2, padding=0), b, t),
        lambda x, c, b, t: L.conv_bn_act(x, c, b, t, relu=False, stride=2, padding=0))),
    "band rows + cropped residual": ((8, 8, 3, True), (
        lambda x, c, b, t: torch.relu(L.batch_norm(
            L.conv2d(F.pad(x, (0, 0, 1, 0)), c, stride=1, padding=(0, 1)), b, t)
            + _crop(x, 1)),
        lambda x, c, b, t: L.conv_bn_act(F.pad(x, (0, 0, 1, 0)), c, b, t, padding=(0, 1),
                                         residual=_crop(x, 1)))),
    "band2 conv1, stride 2": ((8, 8, 3, True), (
        lambda x, c, b, t: torch.relu(L.batch_norm(
            L.conv2d(F.pad(x, (0, 0, 1, 0)), c, stride=2, padding=(0, 1)), b, t)),
        lambda x, c, b, t: L.conv_bn_act(F.pad(x, (0, 0, 1, 0)), c, b, t, stride=2,
                                         padding=(0, 1)))),
    "track2 dilated": ((8, 8, 3, True), (
        lambda x, c, b, t: torch.relu(L.batch_norm(
            L.conv2d(x, c, stride=1, padding=(2, 1), dilation=(2, 1)), b, t)),
        lambda x, c, b, t: L.conv_bn_act(x, c, b, t, padding=(2, 1), dilation=(2, 1)))),
    "track2 stride (1, 2)": ((8, 8, 3, True), (
        lambda x, c, b, t: torch.relu(
            L.batch_norm(L.conv2d(x, c, stride=(1, 2), padding=1), b, t)),
        lambda x, c, b, t: L.conv_bn_act(x, c, b, t, stride=(1, 2)))),
    "no BatchNorm": ((8, 8, 3, True), (
        lambda x, c, b, t: torch.relu(L.batch_norm(L.conv2d(x, c, 1, 1), None, t) + x),
        lambda x, c, b, t: L.conv_bn_act(x, c, None, t, residual=x))),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("form", list(FORMS))
def test_composed_path_is_the_inline_expression(form, dtype, train):
    (cin, cout, k, bias), (inline, fused) = FORMS[form]
    conv, bn = _modules(cin, cout, k, bias, dtype, seed=len(form))
    x = _x((3, cin, 12, 10), dtype, seed=len(form) + 1)
    bn_a, bn_b = bn.train(train), copy.deepcopy(bn).train(train)
    before = bn_act_cuda.launches
    with torch.no_grad():
        want = inline(x, conv, bn_a, train)
        got = fused(x, conv, bn_b, train)
    assert bn_act_cuda.launches == before
    assert got.dtype == dtype and torch.equal(got, want)
    for name in ("running_mean", "running_var", "num_batches_tracked"):
        assert torch.equal(getattr(bn_b, name), getattr(bn_a, name)), name


def test_the_op_has_no_cpu_kernel():
    """The composed chain is the CPU's path; the op itself refuses a CPU
    tensor rather than fall back."""
    with pytest.raises(NotImplementedError):
        torch.ops.laughter_icsi_torch.bn_act(torch.zeros(1, 2, 3, 4), None, None, None, None,
                                             None, None, True, 1e-5)


class _Epilogue(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv, self.bn = _modules(c, c, 3, True, torch.bfloat16, seed=3)

    def forward(self, y, residual):
        """The op twice: its output as ``y``'s shape, then with a zero row
        above it (a band conv's input)."""
        bn = self.bn
        terms = (self.conv.bias, bn.weight, bn.bias, bn.running_mean, bn.running_var)
        return tuple(torch.ops.laughter_icsi_torch.bn_act(
            y, *terms, residual[:, :, 1:], True, L.BN_EPS, *pad) for pad in ((0, 0), (1, 0)))


def test_the_op_exports_with_its_fake():
    """``torch.export`` traces the op through its fake, with a symbolic
    batch and a strided residual: the node keeps ``y``'s shape and dtype,
    and a padded call's node has its zero row."""
    y = _x((4, 6, 5, 7), torch.bfloat16, seed=4)
    res = _x((4, 6, 6, 7), torch.bfloat16, seed=5)
    b = torch.export.Dim("b", min=2)
    with torch.no_grad():
        ep = torch.export.export(_Epilogue(6), (y, res),
                                 dynamic_shapes={"y": {0: b}, "residual": {0: b}})
    nodes = [n for n in ep.graph.nodes
             if n.target is torch.ops.laughter_icsi_torch.bn_act.default]
    assert len(nodes) == 2
    for node, h in zip(nodes, (5, 6)):
        val = node.meta["val"]
        assert val.dtype == torch.bfloat16 and tuple(val.shape[1:]) == (6, h, 7)
        assert isinstance(val.shape[0], torch.SymInt)


@pytest.mark.parametrize("window,shared", [(100, True), (99, True), (100, False)],
                         ids=["stage-2 sharing", "stage-1 sharing", "naive windows"])
def test_chip_smoke_owes_one_launch_for_each_conv_a_classify_step_runs(window, shared):
    """The launches chip_smoke.py holds each path's count to: its
    ``convs_per_bucket`` equals the ``conv_bn_act`` calls one classify
    step makes, two chunks a bucket, with and without the shared stem."""
    import runpy

    from laughter_detection_icsi_tpu_torch import inference
    from laughter_detection_icsi_tpu_torch.models import zoo
    from tests.test_torch_import import REPO

    owed = runpy.run_path(str(REPO / "chip_smoke.py"), run_name="chip_smoke_probe")
    model = zoo.build("ResNetBigger", linear_layer_size=48).eval()
    settings = inference.InferenceSettings(chunk=8, bucket_frames=16, window=window)
    feats = _x((16 + window - 1, 44), torch.float32, seed=5)
    calls = []
    real = L.conv_bn_act
    with pytest.MonkeyPatch.context() as m, torch.inference_mode():
        m.setattr(L, "conv_bn_act", lambda *a, **k: calls.append(1) or real(*a, **k))
        inference.classify_bucket(model, feats, 16, settings, use_shared_stem=shared)
    assert len(calls) == owed["convs_per_bucket"](model, settings, shared) > 0


@pytest.mark.parametrize("sharded", [False, True], ids=["LaughterPipeline", "ShardedPipeline"])
def test_chip_smoke_counts_every_classify_step_of_a_pipeline(sharded):
    """chip_smoke.py's count sees each classify step a pipeline runs: on
    the CPU, where the composed chain launches nothing, a counted run
    fails naming what its steps owe (three channels, two buckets each:
    six steps of 40 convs), and the pipelines' classify step is restored."""
    import runpy

    from laughter_detection_icsi_tpu_torch import inference
    from laughter_detection_icsi_tpu_torch.models import zoo
    from laughter_detection_icsi_tpu_torch.parallel import ShardedPipeline, sharded_inference
    from tests.test_torch_import import REPO

    smoke = runpy.run_path(str(REPO / "chip_smoke.py"), run_name="chip_smoke_probe")
    model = zoo.build("ResNetBigger", linear_layer_size=48)
    settings = inference.InferenceSettings(chunk=16, bucket_frames=16)
    waves = [_x((3000,), torch.float32, seed=c).numpy() * 0.1 for c in range(3 if sharded else 1)]
    pipe = (ShardedPipeline(model, settings=settings, device="cpu") if sharded
            else inference.LaughterPipeline(model, settings=settings, device="cpu"))
    real = inference.classify_bucket
    with pytest.raises(smoke["PhaseError"], match=f"where its classify steps owe "
                                                  f"{len(waves) * 2 * 40}$"):
        with smoke["EPILOGUES"].count("cpu"):
            if sharded:
                pipe.probs_for_waveforms(waves)
            else:
                pipe.probs_for_waveform(waves[0])
    assert inference.classify_bucket is real and sharded_inference.classify_bucket is real


def _cl(t):
    return t.contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("fmt", ["nchw", "nhwc"])
def test_the_ops_fake_keeps_ys_memory_format(fmt):
    """The fake (``torch.export``'s and every fake or meta tensor's view of
    the op) gives ``y``'s memory format, as the kernel's output does."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    y = _x((2, 16, 5, 7), torch.bfloat16, seed=6)
    y = _cl(y) if fmt == "nhwc" else y
    res = _cl(_x((2, 16, 7, 7), torch.bfloat16, seed=7))[:, :, 2:]
    with FakeTensorMode() as mode:
        fake = torch.ops.laughter_icsi_torch.bn_act(mode.from_tensor(y), None, None, None, None,
                                                    None, mode.from_tensor(res), True, 1e-5)
    meta = torch.ops.laughter_icsi_torch.bn_act(y.to("meta"), None, None, None, None, None,
                                                res.to("meta"), True, 1e-5)
    for out in (fake, meta):
        assert out.shape == y.shape and out.dtype == y.dtype and out.stride() == y.stride()


def test_the_layout_check_takes_both_formats_and_refuses_the_rest():
    y = _x((2, 16, 5, 7), torch.float32, seed=8)
    assert bn_act_cuda.layout(y) == "nchw"
    assert bn_act_cuda.layout(_cl(y)) == "nhwc"
    # One channel, or one pixel: both formats are the same bytes; NCHW's form.
    assert bn_act_cuda.layout(_cl(y[:, :1])) == "nchw"
    assert bn_act_cuda.layout(_cl(y[:, :, :1, :1])) == "nchw"
    for bad in (y.transpose(2, 3), y[:, :, 1:], _cl(y)[:, :, 1:], y[0], y[:, ::2]):
        with pytest.raises(ValueError, match="contiguous in NCHW or channels-last"):
            bn_act_cuda.layout(bad)


#: The band convs' residuals: crops along H of the sweep's band and tail
#: outputs ([B, 64, 7, 44] and [B, 16, 25, 11] at a small batch).
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("c,h,w", [(64, 7, 44), (16, 25, 11)], ids=["band", "tail"])
def test_launch_args_give_nhwc_crops_the_vector_loads(dtype, c, h, w):
    """``launch_args``' residual modes: laid out as ``y`` (16-byte loads in
    either form); in NHWC a crop along H, either end (16-byte loads of one
    pixel's channels); an NCHW crop, a residual in the other format, a
    channel count that is no multiple of the vector, or a misaligned ``y``
    (scalar loads)."""
    dense, pixel, strided = (bn_act_cuda._RES_DENSE, bn_act_cuda._RES_PIXEL,
                             bn_act_cuda._RES_STRIDED)
    x = lambda *s: torch.zeros(s, dtype=dtype)
    mode = lambda y, r: bn_act_cuda.launch_args(y, r)[8]
    y, tall = x(3, c, h, w), x(3, c, h + 2, w)
    assert bn_act_cuda.launch_args(y, None) == (3, c, h, w, 0, 0, 0, 0, strided, 1, 0, 0, 0)
    assert mode(y, x(3, c, h, w)) == dense
    assert mode(y, tall[:, :, 2:]) == mode(y, _cl(y)) == strided
    args = bn_act_cuda.launch_args(_cl(y), _cl(tall)[:, :, 2:])
    assert args[4:] == (c * (h + 2) * w, 1, c * w, c, pixel, 1, 1, 0, 0)
    assert mode(_cl(y), _cl(tall)[:, :, :-2]) == pixel
    assert mode(_cl(y), _cl(x(3, c, h, w))) == dense
    assert mode(_cl(y), tall[:, :, 2:]) == mode(_cl(y), x(3, c, h, w)) == strided
    odd, odd_tall = x(3, c + 1, h, w), x(3, c + 1, h + 2, w)
    assert mode(_cl(odd), _cl(odd_tall)[:, :, 2:]) == strided
    base = x(y.numel() + 1)
    off = base[1:].view(3, h, w, c).permute(0, 3, 1, 2)
    assert bn_act_cuda.launch_args(off, _cl(tall)[:, :, 2:])[8:] == (strided, 0, 1, 0, 0)


@pytest.mark.parametrize("pad_rows", [(1, 0), (0, 1), (2, 3)], ids=["top", "bottom", "both"])
@pytest.mark.parametrize("fmt", ["nchw", "nhwc"])
def test_the_ops_fake_gives_the_padded_shape_and_format(fmt, pad_rows):
    """With zero rows the fake gives ``y``'s shape taller by them, dense in
    ``y``'s memory format, as the kernel's output is."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    y = _x((2, 16, 5, 7), torch.bfloat16, seed=6)
    y = _cl(y) if fmt == "nhwc" else y
    res = _cl(_x((2, 16, 7, 7), torch.bfloat16, seed=7))[:, :, 2:]
    want = torch.empty((2, 16, 5 + sum(pad_rows), 7))
    want = _cl(want) if fmt == "nhwc" else want
    with FakeTensorMode() as mode:
        fake = torch.ops.laughter_icsi_torch.bn_act(mode.from_tensor(y), None, None, None, None,
                                                    None, mode.from_tensor(res), True, 1e-5,
                                                    *pad_rows)
    meta = torch.ops.laughter_icsi_torch.bn_act(y.to("meta"), None, None, None, None, None,
                                                res.to("meta"), True, 1e-5, *pad_rows)
    for out in (fake, meta):
        assert out.shape == want.shape and out.dtype == y.dtype and out.stride() == want.stride()


def test_the_op_refuses_a_negative_pad_or_a_y_of_another_rank():
    """The wrapper's check, which the kernel's launch and the fake share."""
    y = _x((2, 16, 5, 7), torch.bfloat16, seed=8)
    op = lambda y, *pad: torch.ops.laughter_icsi_torch.bn_act(
        y.to("meta"), None, None, None, None, None, None, True, 1e-5, *pad)
    for bad in ((y, -1, 0), (y, 0, -1), (y[0], 1, 0), (y[None], 0, 1)):
        with pytest.raises(ValueError, match="pads a 4-d y by rows >= 0"):
            op(*bad)
        with pytest.raises(ValueError, match="pads a 4-d y by rows >= 0"):
            bn_act_cuda.launch_args(bad[0], None, bad[1:])
    assert bn_act_cuda.padded_shape(y, (1, 2)) == (2, 16, 8, 7)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_launch_args_give_the_geometry_of_a_padded_output(dtype):
    """A padded launch's geometry is ``y``'s, its residual's and the zero
    rows above and below; the residual an H-crop of a padded band's
    interior keeps its 16-byte loads in NHWC."""
    c, h, w = 64, 7, 44
    y = _cl(torch.zeros((3, c, h, w), dtype=dtype))
    band = _cl(torch.zeros((3, c, h + 3, w), dtype=dtype))  # a zero row above h + 2 rows
    res = band[:, :, 1:][:, :, : h]
    for pad in ((1, 0), (0, 1)):
        assert bn_act_cuda.launch_args(y, res, pad) == (
            3, c, h, w, c * (h + 3) * w, 1, c * w, c, bn_act_cuda._RES_PIXEL, 1, 1, *pad)
    nchw = torch.zeros((3, c, h, w), dtype=dtype)
    assert bn_act_cuda.launch_args(nchw, None, (0, 1))[-4:] == (1, 0, 0, 1)


def _band_input(fmt, dtype):
    x = _x((3, 8, 9, 10), dtype, seed=9)
    return _cl(x) if fmt == "nhwc" else x


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("fmt", ["nchw", "nhwc"])
@pytest.mark.parametrize("pad_rows", [(1, 0), (0, 1)], ids=["top", "bottom"])
def test_the_plain_padded_epilogue_is_f_pad_of_the_chain(pad_rows, fmt, dtype):
    """``conv_bn_act(..., pad_rows=p)``'s plain version is ``F.pad`` of
    the unpadded chain, bit for bit, in the input's memory format: a band
    conv's result with the zero row the next band conv reads, with and
    without a residual cropped from a padded band."""
    conv, bn = _modules(8, 8, 3, True, dtype, seed=10)
    if fmt == "nhwc":
        conv = conv.to(memory_format=torch.channels_last)
    x = _band_input(fmt, dtype)
    res = _band_input(fmt, dtype)[:, :, 1:][:, :, :7]
    before = bn_act_cuda.launches
    with torch.no_grad():
        for r in (None, res):
            want = F.pad(L.conv_bn_act(x, conv, bn, residual=r, padding=(0, 1)),
                         (0, 0, *pad_rows))
            got = L.conv_bn_act(x, conv, bn, residual=r, padding=(0, 1), pad_rows=pad_rows)
            assert got.shape == (3, 8, 8, 10) and torch.equal(got, want)
            assert got.is_contiguous(memory_format=torch.channels_last) == (fmt == "nhwc")
            row = 0 if pad_rows[0] else -1
            assert not got[:, :, row].any()
    assert bn_act_cuda.launches == before


@pytest.mark.parametrize("window,shared", [(100, True), (99, True), (100, False)],
                         ids=["stage-2 sharing", "stage-1 sharing", "naive windows"])
def test_chip_smoke_owes_the_padded_launches_a_classify_step_runs(window, shared):
    """chip_smoke.py's ``padded_per_bucket`` equals the ``conv_bn_act``
    calls of one classify step (two chunks a bucket) that ask for zero
    rows: 14 a chunk with stage-2 sharing, 8 with stage 1's, none naive."""
    import runpy

    from laughter_detection_icsi_tpu_torch import inference
    from laughter_detection_icsi_tpu_torch.models import zoo
    from tests.test_torch_import import REPO

    owed = runpy.run_path(str(REPO / "chip_smoke.py"), run_name="chip_smoke_probe")
    model = zoo.build("ResNetBigger", linear_layer_size=48).eval()
    settings = inference.InferenceSettings(chunk=8, bucket_frames=16, window=window)
    feats = _x((16 + window - 1, 44), torch.float32, seed=5)
    calls = []
    real = L.conv_bn_act
    with pytest.MonkeyPatch.context() as m, torch.inference_mode():
        m.setattr(L, "conv_bn_act", lambda *a, **k: calls.append(any(k.get("pad_rows", ())))
                  or real(*a, **k))
        inference.classify_bucket(model, feats, 16, settings, use_shared_stem=shared)
    assert sum(calls) == owed["padded_per_bucket"](model, settings, shared) == {
        (100, True): 28, (99, True): 16, (100, False): 0}[window, shared]
