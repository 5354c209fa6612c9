"""The port's CLIs over two processes on the CPU (``--coordinator_address
file://... --num_processes 2 --process_id i --device cpu``): ``cli/sweep``
splits every meeting's channels and writes the one-process sweep's
TextGrids; processes that see other audio refuse together; ``cli/train
--data_parallel`` takes the one-process step.

The sweeps run ``--mode fused_conv``, the CPU's fast path (6 s where
windows mode takes 27 s for these 60 channel-seconds at full width); the
windows path over two processes is held to one process's in
tests/test_torch_distributed.py.

Each spawn runs its two processes under a 240 s timeout (collectives wait at
most the process group's default 30 minutes, so the timeout is what ends a
hang), with two torch threads each.

The training comparison is one step: the split is one global batch.  A
second step is not comparable at 1e-6 between any two roundings of this
step: Adam's first step moves every element whose gradient is near its
rounding noise (a conv bias in front of a BatchNorm has a true gradient of
0) by ~lr with the noise's sign, and the runs then part (the one-process
step alone, on one thread and on eight, differs by 4e-4 in its third
step's loss).  So the checkpoints are held as tests/test_torch_train.py
holds one step: BatchNorm's running statistics within 1e-6, Adam's first
moment (0.1 x the clipped gradient) within 1e-5, the parameters within
1e-6 of Adam applied to the checkpoint's own moment, and within 1e-6 of the
one-process step where the gradient is above 16x the largest gradient
difference.
"""

import contextlib
import io
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from laughter_detection_icsi_tpu_torch.cli import sweep, train
from laughter_detection_icsi_tpu_torch.config import MODEL_MAP
from laughter_detection_icsi_tpu_torch.data import audio
from laughter_detection_icsi_tpu_torch.models import zoo
from laughter_detection_icsi_tpu_torch.train import Adam
from laughter_detection_icsi_tpu_torch.train import checkpoint as ckpt
from laughter_detection_icsi_tpu_torch.train.checkpoint import state_dict_from_jax
from tests.fixtures.mrt import _meeting_xml, _segment
from tests.fixtures.torch_weights import few_torch_threads, numpy_weights  # noqa: F401
from tests.test_torch_train_resident import corpus, train_argv  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
PRESET = MODEL_MAP["resnet_base"]
WIDTHS = dict(linear_layer_size=PRESET.linear_layer_size, filter_sizes=PRESET.filter_sizes)
MEETINGS = ("Bmr021", "Btr001")
CHANNELS = ("chan0", "chan1", "chan2")
SECONDS = 10


def run_ranks(module: str, argv_of, tmp: Path, n: int = 2, timeout: float = 240):
    """``n`` processes of ``python -m module`` joined through a file in
    ``tmp``; [(rc, stdout, stderr)] by rank."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    rendezvous = tmp / "rendezvous"
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *argv_of(r), "--coordinator_address",
         f"file://{rendezvous}", "--num_processes", str(n), "--process_id", str(r)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    logs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            logs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return logs


def run_here(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _wave(seconds: int, seed: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    t = np.arange(16000 * seconds) / 16000
    w = 0.3 * r.standard_normal(len(t)) * (0.05 + 0.6 * np.sin(2 * np.pi * 0.4 * t) ** 2)
    return (np.clip(w, -1, 1) * 32767).astype(np.int16)


@pytest.fixture(scope="module")
def meetings(tmp_path_factory):
    """Two meetings of three 10 s channels (int16 WAV), their transcripts
    and a full-width ``resnet_base`` checkpoint."""
    root = tmp_path_factory.mktemp("torch_dist_cli")
    tdir = root / "transcripts"
    tdir.mkdir()
    people = [f"me00{i}" for i in range(len(CHANNELS))]
    pre = ['<?xml version="1.0" encoding="UTF-8"?>', "<Preambles>"]
    for m in MEETINGS:
        pre += [f'  <Meeting Session="{m}" DateTimeStamp="2000-01-01">', "    <Preamble>",
                "      <Participants>"]
        pre += [f'        <Participant Name="{p}" Channel="{c}"/>'
                for p, c in zip(people, CHANNELS)]
        pre += ["      </Participants>", "      <Channels>"]
        pre += [f'        <Channel Name="{c}" AudioFile="{c}.sph"/>' for c in CHANNELS]
        pre += ["      </Channels>", "    </Preamble>", "  </Meeting>"]
        segments = [_segment(p, 1.0 + i, 2.5 + i, '<VocalSound Description="laugh"/>')
                    for i, p in enumerate(people)]
        segments += [_segment(people[0], 6.0, 8.0, "some speech")]
        (tdir / f"{m}.mrt").write_text(_meeting_xml(m, float(SECONDS), segments))
    (tdir / "preambles.mrt").write_text("\n".join(pre + ["</Preambles>", ""]))
    for i, m in enumerate(MEETINGS):
        for j, c in enumerate(CHANNELS):
            (root / "audio" / m).mkdir(parents=True, exist_ok=True)
            audio.write_wav(str(root / "audio" / m / f"{c}.wav"), _wave(SECONDS, 3 * i + j),
                            16000)
    _, params, state = numpy_weights(PRESET.model, seed=5, head_gain=0.05, **WIDTHS)
    model = zoo.build(PRESET.model, dropout_rate=0.0, **WIDTHS)
    model.load_state_dict(state_dict_from_jax(params, state), strict=True)
    path = ckpt.save_checkpoint(str(root / "ck"), model.state_dict())
    return dict(root=root, transcripts=tdir, audio=root / "audio", ckpt=path)


def sweep_argv(meetings, out: Path, audio_dir=None):
    return ["--audio_dir", str(audio_dir or meetings["audio"]), "--transcript_dir",
            str(meetings["transcripts"]), "--output_dir", str(out), "--split", "all",
            "--model_path", meetings["ckpt"], "--device", "cpu", "--mode", "fused_conv",
            "--bucket_frames", "1024", "--thresholds", "0.3,0.5", "--min_lengths", "0,0.2",
            "--analyse"]


def tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*.TextGrid"))}


def test_two_process_sweep_writes_the_one_process_textgrids(meetings, tmp_path):
    rc, one_out = run_here(sweep.main, sweep_argv(meetings, tmp_path / "one"))
    assert rc == 0
    logs = run_ranks("laughter_detection_icsi_tpu_torch.cli.sweep",
                     lambda r: sweep_argv(meetings, tmp_path / "two"), tmp_path)
    assert all(rc == 0 for rc, _, _ in logs), logs
    one, two = tree(tmp_path / "one"), tree(tmp_path / "two")
    assert len(one) == len(MEETINGS) * len(CHANNELS) * 2 * 2
    assert one == two
    (_, out0, _), (_, out1, _) = logs
    assert "process 0/2" in out0 and "process 1/2" in out1
    # The coordinator alone scores the split, and scores it as one process does.
    assert "analyse on coordinator" in out0 and "analyse on coordinator" not in out1
    report = lambda text: [ln for ln in text.splitlines() if ln.startswith(("best F1", "AP("))]
    assert report(out0) and report(out0) == report(one_out)


def test_processes_that_see_other_audio_refuse_together(meetings, tmp_path):
    other = tmp_path / "other_audio"
    shutil.copytree(meetings["audio"], other)
    path = other / MEETINGS[1] / f"{CHANNELS[2]}.wav"
    audio.write_wav(str(path), _wave(SECONDS - 1, 0), 16000)  # a shorter copy
    logs = run_ranks("laughter_detection_icsi_tpu_torch.cli.sweep",
                     lambda r: sweep_argv(meetings, tmp_path / "out", other if r else None),
                     tmp_path, timeout=120)
    for rc, _, err in logs:
        assert rc != 0 and "lists or file headers differ across processes" in err, err
    assert not list((tmp_path / "out").rglob("*.TextGrid"))


def assert_same_step(a: dict, b: dict, start: dict) -> None:
    """Checkpoint ``a`` (several processes) took the step that ``b`` (one
    process) took from the parameters ``start``: the rule of the module
    docstring."""
    sa, sb = a["state_dict"], b["state_dict"]
    assert sa.keys() == sb.keys() and (a["global_step"], a["epoch"]) == (1, 1)
    for n in sa:
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sa[n].numpy(), sb[n].numpy(), atol=1e-6, rtol=0,
                                       err_msg=n)
        if n.endswith("num_batches_tracked"):
            assert int(sa[n]) == int(sb[n]), n
    mu_a, mu_b = a["opt_state"].mu, b["opt_state"].mu
    for k in mu_a:
        np.testing.assert_allclose(mu_a[k].numpy(), mu_b[k].numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)
    adam = Adam(max_grad_norm=None)  # the moment holds the clipped gradient
    redo = {k: v.clone() for k, v in start.items()}
    adam.update({k: m / (1 - adam.b1) for k, m in mu_a.items()}, adam.init(redo), redo)
    noise = max(float((mu_a[k] - mu_b[k]).abs().max()) for k in mu_a)
    held = 0
    for k in mu_a:
        np.testing.assert_allclose(sa[k].numpy(), redo[k].numpy(), atol=1e-6, rtol=0,
                                   err_msg=k)
        sure = (mu_b[k].abs() > 16 * noise).numpy()
        np.testing.assert_allclose(sa[k].numpy()[sure], sb[k].numpy()[sure], atol=1e-6, rtol=0,
                                   err_msg=k)
        held += int(sure.sum())
    assert held >= 1000


@pytest.mark.parametrize("cache", ["off", "on"])
def test_two_process_data_parallel_train_takes_the_one_process_step(corpus, cache, tmp_path):
    flags = ["--data_parallel", "--batch_size", "24", "--device_cache", cache, "--seed", "3"]
    rc, one_out = run_here(train.main, train_argv(corpus, f"one_{cache}", *flags))
    assert rc == 0 and "data-parallel over 1 devices" in one_out
    logs = run_ranks("laughter_detection_icsi_tpu_torch.cli.train",
                     lambda r: train_argv(corpus, f"two_{cache}", *flags), tmp_path)
    assert all(rc == 0 for rc, _, _ in logs), logs
    (_, out0, _), (_, out1, _) = logs
    assert "multi-host: process 0 feeds 12 of 24 rows/batch" in out0
    assert "multi-host: process 1 feeds 12 of 24 rows/batch" in out1
    if cache == "on":
        assert "device cache: 24 train windows resident" in out0
    loss = lambda text: float(text.split("mean train loss ")[1].split()[0])
    assert loss(out0) == loss(out1) == pytest.approx(loss(one_out), abs=1e-4)
    start = dict(zoo.build(PRESET.model, dropout_rate=0.5, seed=3, **WIDTHS).named_parameters())
    start = {k: v.detach() for k, v in start.items()}
    state = lambda name: ckpt.load_checkpoint(str(corpus / name / "last.ckpt.npz"))
    assert_same_step(state(f"two_{cache}"), state(f"one_{cache}"), start)
    # The coordinator is the one writer.
    assert sorted(p.name for p in (corpus / f"two_{cache}").iterdir()) == sorted(
        p.name for p in (corpus / f"one_{cache}").iterdir())
