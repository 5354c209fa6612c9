"""The port's host tools and examples: ``cli/laughs_to_wav`` writes the
same WAV bytes as the JAX CLI on the same TextGrid and audio;
``cli/probe_audio_loading`` prints the JAX CLI's header (decoder
included) and offsets; ``examples/demo_torch.py`` and
``examples/streaming_demo_torch.py`` run as subprocesses with ``--device
cpu`` (the CPU widths), leave their artifacts and print the streaming
equality line.  The two demos start together when the module starts and
run while the CLI tests do (a few torch threads each)."""

import contextlib
import filecmp
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from cli import laughs_to_wav as jax_laughs_to_wav
from cli import probe_audio_loading as jax_probe
from laughter_detection_icsi_tpu_torch.cli import laughs_to_wav, probe_audio_loading
from laughter_detection_icsi_tpu_torch.data import audio
from laughter_detection_icsi_tpu_torch.eval import textgrid as tg

REPO = Path(__file__).resolve().parent.parent
DEMOS = {"demo": (["examples/demo_torch.py"], "4"),
         "streaming": (["examples/streaming_demo_torch.py"], "2")}


@pytest.fixture(scope="module", autouse=True)
def demos(tmp_path_factory):
    """Both demos, started when the module starts; ``demos[name]()`` waits
    for one: (returncode, stdout, stderr, workdir)."""
    work = tmp_path_factory.mktemp("demo_torch")
    procs, done = {}, {}
    for name, (argv, threads) in DEMOS.items():
        extra = [str(work)] if name == "demo" else []
        env = dict(os.environ, OMP_NUM_THREADS=threads)
        procs[name] = subprocess.Popen(
            [sys.executable, *argv, *extra, "--device", "cpu"], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def result(name):
        if name not in done:
            stdout, stderr = procs[name].communicate(timeout=600)
            done[name] = (procs[name].returncode, stdout, stderr, work)
        return done[name]

    yield {name: (lambda n=name: result(n)) for name in procs}
    for p in procs.values():
        p.kill()
        p.communicate()


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools")
    sr = 16000
    wav = (np.random.default_rng(23).standard_normal(sr * 5) * 0.1).astype(np.float32)
    src = d / "chan0.sph"
    audio.write_sphere(str(src), wav, sr)
    grid = d / "chan0.TextGrid"
    tg.write_textgrid(str(grid), [(0.5, 1.0), (2.0, 3.5), (4.25, 4.9)], xmax=5.0)
    return src, grid


def test_laughs_to_wav_writes_the_jax_bytes(source, tmp_path):
    src, grid = source
    argv = ["--textgrid", str(grid), "--audio_file", str(src), "--concat", "--break_s", "0.25"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert jax_laughs_to_wav.main(argv + ["--output_dir", str(tmp_path / "jax")]) == 0
    ours = io.StringIO()
    with contextlib.redirect_stdout(ours):
        assert laughs_to_wav.main(argv + ["--output_dir", str(tmp_path / "port")]) == 0
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 4 and "all_laughs.wav" in names
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "jax", tmp_path / "port", names,
                                               shallow=False)
    assert match == names, (mismatch, errors)
    # Each piece is the audio of its interval; the concatenation has the gaps.
    pieces = []
    for start, end in tg.read_laughter_intervals(str(grid)):
        want, _ = audio.read(str(src), offset=start, duration=end - start)
        piece = tmp_path / "port" / f"laugh_{len(pieces)}_{start:.2f}-{end:.2f}.wav"
        got, _ = audio.read(str(piece))
        np.testing.assert_allclose(got, want, atol=1 / 32767)
        pieces.append(len(want))
    concat, _ = audio.read(str(tmp_path / "port" / "all_laughs.wav"))
    assert len(concat) == sum(pieces) + 2 * int(0.25 * 16000)
    assert "concatenated 3 laughs" in ours.getvalue()


def _probe(main, argv) -> list:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue().splitlines()


def test_probe_prints_the_jax_offsets_and_decoder(source):
    src, _ = source
    argv = [str(src), "--duration", "1.0", "--offsets", "0,1.5,9"]
    ours, theirs = _probe(probe_audio_loading.main, argv), _probe(jax_probe.main, argv)
    assert ours[0] == theirs[0]
    assert "decoder native" in ours[0]  # g++ builds the port's decoder here
    timed = re.compile(r"offset +([\d.]+)s: +[\d.]+ ms for ([\d.]+)s audio \(RTF [\d.]+\)")
    assert [timed.sub(r"\1 \2", ln) for ln in ours[1:]] == [
        timed.sub(r"\1 \2", ln) for ln in theirs[1:]]
    assert ours[1:] and ours[-1] == "offset     9.0s: skipped (past end of file)"


def test_demo_runs_end_to_end(demos):
    rc, stdout, stderr, work = demos["demo"]()
    assert rc == 0, stderr[-3000:]
    assert list(work.glob("signals/*/*.sph"))
    assert list(work.glob("feats/*/*.npy"))
    grids = list(work.glob("preds/dev/*/t_0.3/l_0.2/*.TextGrid"))
    assert len(grids) == 2, stdout[-3000:]
    assert "trained" in stdout and "corpus-weighted evaluation:" in stdout
    assert (work / "preds" / "dev_sum_stats.csv").is_file()


def test_streaming_demo_runs_and_matches_offline(demos):
    rc, stdout, stderr, _ = demos["streaming"]()
    assert rc == 0, stderr[-3000:]
    assert "bit-identical to the offline pipeline" in stdout
    assert "4500 frames emitted for 45s of audio" in stdout
