"""The port's ``utils/timing.py`` on the CPU: ``checksum`` / ``hard_block``
against the JAX package's on the same numpy-seeded trees, the slope timer,
the kernel kinds of real kernel names (PERF.md section 5) and the trace
arithmetic of ``summarize_device_events`` on a synthetic trace.  The
CUDA-event timer and the barrier behind a long kernel need the card
(tests/test_torch_cuda.py)."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laughter_detection_icsi_tpu.utils import timing as jtiming
from laughter_detection_icsi_tpu_torch.utils import timing
from tests.fixtures.torch_weights import few_torch_threads  # noqa: F401


def _trees(seed: int):
    """One tree of float32, int16 and bfloat16 leaves in nested dicts,
    lists and tuples, as numpy: a bf16 leaf is ("bf16", a float32 array),
    which both frameworks round to bf16."""
    rng = np.random.default_rng(seed)
    return {
        "b": [rng.standard_normal((3, 5)).astype(np.float32),
              {"z": rng.integers(-2000, 2000, 17).astype(np.int16),
               "a": ("bf16", rng.standard_normal(64).astype(np.float32))}],
        "a": (rng.standard_normal(7).astype(np.float32) * 100,),
    }


def _convert(tree, leaf):
    if isinstance(tree, dict):
        return {k: _convert(v, leaf) for k, v in tree.items()}
    if isinstance(tree, tuple) and isinstance(tree[0], str):  # ("bf16", array)
        return leaf(tree[1], bf16=True)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_convert(v, leaf) for v in tree)
    return leaf(tree, bf16=False)


def _jax(x, bf16):
    return jnp.asarray(x, jnp.bfloat16) if bf16 else jnp.asarray(x)


def _torch(x, bf16):
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if bf16 else t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_checksum_and_hard_block_match_jax(seed):
    tree, extra = _trees(seed), _trees(seed + 10)["b"]
    want = jtiming.hard_block(_convert(tree, _jax), _convert(extra, _jax))
    got = timing.hard_block(_convert(tree, _torch), _convert(extra, _torch))
    assert got == pytest.approx(want, rel=1e-6)
    c = timing.checksum(_convert(tree, _torch))
    assert c.dtype == torch.float32 and c.ndim == 0
    assert c.item() == pytest.approx(float(np.asarray(jtiming.checksum(_convert(tree, _jax)))),
                                     rel=1e-6)


def test_hard_block_reads_values_as_jax():
    # 0+1+2+3 + 6*1 and 1+2 + 0.5: JAX's own cases.
    assert timing.hard_block({"a": torch.arange(4.0), "b": (torch.ones(2, 3),)}) == 12.0
    assert timing.hard_block(torch.tensor([1, 2], dtype=torch.int32),
                             torch.tensor([0.5], dtype=torch.bfloat16)) == 3.5


@pytest.mark.parametrize("impl", ["jax", "torch"])
def test_checksum_rejects_no_arrays(impl):
    mod = jtiming if impl == "jax" else timing
    with pytest.raises(ValueError, match="no array leaves"):
        mod.checksum({"a": None}, [])


@pytest.mark.parametrize("impl", ["jax", "torch"])
def test_slope_time_validates_n(impl):
    mod = jtiming if impl == "jax" else timing
    with pytest.raises(ValueError, match="n_hi > n_lo"):
        mod.slope_time(lambda n: None, n_lo=4, n_hi=4)


def test_slope_time_recovers_per_call_cost():
    per, over = 0.02, 0.05

    def run(n):
        time.sleep(over + n * per)

    per_exec, overhead = timing.slope_time(run, n_lo=1, n_hi=5, repeats=3)
    assert abs(per_exec - per) <= 0.25 * per
    assert overhead == pytest.approx(over, abs=0.25 * over + 0.25 * per)


#: Kernel names as chip_smoke.py's breakdowns print them on an H100 (the
#: first 100 characters; PERF.md section 5) and their kinds.
KERNELS = [
    ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<at::native::CUDAFunct",
     "elementwise"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::FillFunctor<c10::BFloat16>, std::array",
     "elementwise"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, __nv_bfloat16, float, false, true, ",
     "layout"),
    ("void cudnn::engines_precompiled::nhwcToNchwKernel<__nv_bfloat16, __nv_bfloat16, float, true, false, ",
     "layout"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize256x64x32_warpgroupsize1x1x",
     "convs"),
    ("void implicit_convolve_sgemm<__nv_bfloat16, __nv_bfloat16, 1024, 5, 5, 3, 3, 3, 1, false, false, tru",
     "convs"),
    ("void precomputed_convolve_sgemm<__nv_bfloat16, 128, 5, 5, 3, 3, 3, 1, false>(int, int, int, __nv_bfl",
     "convs"),
    ("void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_optimized_bf16_256x64_32x4_nhwc_ali",
     "convs"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::native::(anonymous namespace)::Opaqu",
     "cat"),
    ("Memcpy HtoD (Pageable -> Device)", "copies"),
    ("Memset (Device)", "copies"),
    ("fbank_kernel", "fbank"),
    # The conv epilogue (csrc/bn_act.cu): elementwise work, counted there.
    ("void bn_act_kernel<__nv_bfloat16, 8>(BnActArgs<__nv_bfloat16>)", "elementwise"),
    ("void bn_act_kernel<float, 4>(BnActArgs<float>)", "elementwise"),
    # Its NHWC form, and the splice of channels-last pieces.
    ("void bn_act_nhwc_kernel<__nv_bfloat16, 8>(BnActArgs<__nv_bfloat16>)", "elementwise"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy_alignedK_contig<at::native::(anonymous n",
     "cat"),
]


@pytest.mark.parametrize("name, kind", KERNELS, ids=[k for _, k in KERNELS])
def test_kernel_kind_of_real_names(name, kind):
    assert timing.kernel_kind(name) == kind


def _event(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_summarize_device_events_on_overlapping_intervals():
    conv = KERNELS[4][0]
    events = [
        _event(conv, 0.0, 100.0),
        _event("fbank_kernel", 50.0, 100.0),       # overlaps the conv by 50 us
        _event("fbank_kernel", 300.0, 50.0),
        _event("Memcpy HtoD (Pageable -> Device)", 320.0, 10.0, "gpu_memcpy"),  # inside
        _event(KERNELS[0][0], 400.0, 40.0),
        _event("aten::conv2d", 0.0, 1000.0, "cpu_op"),   # host events are not device time
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5.0},
    ]
    s = timing.summarize_device_events(events)
    assert s["n_ops"] == 5
    assert s["total_ms"] == pytest.approx(0.300)              # 100+100+50+10+40 us
    assert s["busy_ms"] == pytest.approx(0.240)               # [0,150) + [300,350) + [400,440)
    assert s["by_name"]["fbank_kernel"] == (2, pytest.approx(0.150))
    assert s["fbank_launches"] == 2 and s["fbank_ms"] == pytest.approx(0.150)
    assert s["fbank_share"] == pytest.approx(0.5)
    assert s["kinds"] == pytest.approx({"convs": 1 / 3, "fbank": 0.5, "copies": 1 / 30,
                                        "elementwise": 4 / 30})
    assert [r[0] for r in s["top"]] == ["fbank_kernel", conv, KERNELS[0][0],
                                        "Memcpy HtoD (Pageable -> Device)"]
    assert timing.summarize_device_events([_event("aten::mm", 0.0, 5.0, "cpu_op")]) is None


def test_chip_smoke_measures_with_these_helpers():
    """chip_smoke.py keeps no copies: its timer and breakdowns are this
    module's."""
    import runpy

    from tests.test_torch_import import REPO

    ns = runpy.run_path(str(REPO / "chip_smoke.py"), run_name="chip_smoke_probe")
    for name in ("cuda_ms", "device_breakdown", "kernel_kind"):
        assert ns[name] is getattr(timing, name), name
