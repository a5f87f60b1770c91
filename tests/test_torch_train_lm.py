"""The port's ``examples/train_transformer_lm.py`` against the JAX
package's.

Both examples run with the same flags (a 2-layer, dim-32 LM, batch 2,
seq 16, adamw) from the same weights (the JAX example's ``PRNGKey(0)``
init, converted), at world 1 and at world 2 (the port over gloo in two
spawned CPU ranks, the JAX example on a 2-device mesh). Limits (float32,
summation order only; seen 2.5e-7):

- every loss rtol 1e-5, the eval nll rtol 1e-5, the greedy generated
  tokens equal;
- ``ByteCorpus`` arrays equal the JAX ones exactly (a file, a directory,
  the byte cap);
- save then ``--resume`` gives exactly the continued losses of the
  uninterrupted run (with and without ``--prefetch``), as the JAX
  package's ``test_transformer_lm_checkpoint_resume_exact`` asserts of
  itself; a checkpoint the JAX example wrote resumes in the port with
  the JAX run's continued losses (rtol 1e-5);
- ``--fused-ce --clip-norm --warmup-steps`` over ``--text`` against the
  JAX example (rtol 1e-5); ``--trace`` and ``--log`` write their files;
  ``--elastic`` without ``--save`` exits with the JAX example's message,
  and beside ``--sharded-ckpt --save`` runs in its supervised child
  (``--fsdp``: ``test_torch_fsdp.py``; ``--sharded-ckpt``:
  ``test_torch_ckpt_sharded.py``; the elastic relaunch:
  ``test_torch_elastic.py``).

Serial run time ~31 s.
"""

import contextlib
import importlib
import io
import json
import re

import jax
import numpy as np
import pytest
import torch

import distributed_pytorch_tpu as jdist
from _torch_port import launch_cpu_ranks
from distributed_pytorch_tpu import models as jmodels
from distributed_pytorch_tpu_torch.examples import train_transformer_lm

jex = importlib.import_module("examples.train_transformer_lm")

MODEL = ["--dim", "32", "--n-layers", "2", "--n-heads", "4",
         "--seq-len", "16"]
ARGS = MODEL + ["--steps", "8", "--batch-size", "2", "--data-size", "64",
                "--log-every", "1"]
CPU = ["--device", "cpu"]


def _jax_init(argv):
    a = train_transformer_lm.parse_args(argv)
    model = jmodels.TransformerLM(vocab=256, dim=a.dim,
                                  n_layers=a.n_layers, n_heads=a.n_heads,
                                  max_seq=a.seq_len)
    return jax.tree_util.tree_map(np.asarray,
                                  model.init(jax.random.PRNGKey(0)))


def _jax_run(argv, monkeypatch, world=1):
    """The JAX example's losses, logged records and printed lines."""
    monkeypatch.setenv("DPX_CPU_DEVICES", "8")
    logged = []
    orig = jex.MetricsLogger.log
    monkeypatch.setattr(jex.MetricsLogger, "log", lambda self, step, **m: (
        logged.append(m), orig(self, step, **m)))
    hist = []
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jex.main_worker(0, world, argv, quiet=True, history=hist)
    jdist.cleanup()
    return hist, logged, out.getvalue()


def _jax_generated(printed):
    m = re.search(r"generated tokens: (\[[^\]]*\])", printed)
    return json.loads(m.group(1))


def _jax_eval_nll(logged):
    return [m["eval_nll"] for m in logged if "eval_nll" in m][0]


@pytest.mark.parametrize("kind", ["file", "directory"])
def test_byte_corpus_matches_jax(tmp_path, kind):
    rng = np.random.default_rng(0)
    root = tmp_path / "corpus"
    (root / "b").mkdir(parents=True)
    for name in ("a.py", "b/c.txt", "b/d.md", "e.bin", "f.rst"):
        (root / name).write_bytes(rng.integers(0, 256, 300).astype(
            np.uint8).tobytes())
    path = str(root / "a.py") if kind == "file" else str(root)
    for kw in ({}, {"max_bytes": 700}):
        if kind == "file" and kw:
            continue
        got = train_transformer_lm.ByteCorpus(path, 16, **kw)
        want = jex.ByteCorpus(path, 16, **kw)
        np.testing.assert_array_equal(got.x, want.x)
        np.testing.assert_array_equal(got.y, want.y)
        assert got.x.dtype == np.int32 and len(got) == len(want)
        np.testing.assert_array_equal(got[0][1][:-1], got[0][0][1:])


def test_world1_matches_jax_example(monkeypatch):
    argv = ARGS + ["--eval", "--generate", "8"]
    hist, logged, printed = _jax_run(argv, monkeypatch)
    rec = train_transformer_lm.main_worker(0, 1, argv + CPU, quiet=True,
                                           init_params=_jax_init(argv))
    assert len(rec["losses"]) == len(hist) == 8
    np.testing.assert_allclose(rec["losses"], hist, rtol=1e-5)
    np.testing.assert_allclose(rec["eval_nll"], _jax_eval_nll(logged),
                               rtol=1e-5)
    assert rec["generated"] == _jax_generated(printed)


def test_world2_gloo_matches_jax_example(monkeypatch, tmp_path):
    argv = ARGS + ["--eval"]
    hist, logged, _ = _jax_run(argv, monkeypatch, world=2)
    launch_cpu_ranks(train_transformer_lm.main_worker, 2, argv + CPU, True,
                     None, str(tmp_path), _jax_init(argv))
    for r in range(2):
        rec = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        assert rec["world_size"] == 2 and len(rec["losses"]) == 8
        np.testing.assert_allclose(rec["losses"], hist, rtol=1e-5)
        np.testing.assert_allclose(rec["eval_nll"], _jax_eval_nll(logged),
                                   rtol=1e-5)


@pytest.mark.parametrize("prefetch", ["0", "2"])
def test_resume_is_exact(tmp_path, prefetch):
    ck = str(tmp_path / "ck")
    common = MODEL + CPU + ["--batch-size", "2", "--data-size", "16",
                            "--log-every", "1", "--prefetch", prefetch]
    full = []
    train_transformer_lm.main_worker(0, 1, ["--steps", "9"] + common,
                                     quiet=True, history=full)
    part = []
    train_transformer_lm.main_worker(
        0, 1, ["--steps", "5", "--save", ck, "--save-every", "4"] + common,
        quiet=True, history=part)
    resumed = []
    rec = train_transformer_lm.main_worker(
        0, 1, ["--steps", "9", "--save", ck, "--resume", "--save-every",
               "100"] + common, quiet=True, history=resumed)
    from distributed_pytorch_tpu_torch.utils.checkpoint import latest_step
    assert latest_step(ck) == 8          # the forced save of the last step
    assert rec["start_step"] == 5 and len(resumed) == 4
    assert part == full[:5]
    assert resumed == full[5:9]


def test_resume_from_a_jax_checkpoint(tmp_path, monkeypatch):
    ck = str(tmp_path / "ck")
    full, _, _ = _jax_run(ARGS, monkeypatch)
    _jax_run(ARGS + ["--steps", "5", "--save", ck, "--save-every", "4"],
             monkeypatch)
    rec = train_transformer_lm.main_worker(
        0, 1, ARGS + CPU + ["--save", ck, "--resume"], quiet=True)
    assert rec["start_step"] == 5
    np.testing.assert_allclose(rec["losses"], full[5:], rtol=1e-5)


def test_fused_ce_schedule_and_text_match_jax(tmp_path, monkeypatch):
    text = tmp_path / "corpus.txt"
    text.write_bytes(np.random.default_rng(1).integers(
        0, 256, 2000).astype(np.uint8).tobytes())
    argv = MODEL + ["--steps", "6", "--batch-size", "2", "--log-every", "2",
                    "--text", str(text), "--fused-ce", "--clip-norm", "1",
                    "--warmup-steps", "2", "--lr", "1e-2", "--eval"]
    hist, logged, _ = _jax_run(argv, monkeypatch)
    rec = train_transformer_lm.main_worker(0, 1, argv + CPU, quiet=True,
                                           init_params=_jax_init(argv))
    np.testing.assert_allclose(rec["losses"], hist, rtol=1e-5)
    np.testing.assert_allclose(rec["eval_nll"], _jax_eval_nll(logged),
                               rtol=1e-5)


def test_trace_log_and_the_done_line(tmp_path, capsys):
    log = tmp_path / "m.jsonl"
    rec = train_transformer_lm.main_worker(
        0, 1, MODEL + CPU + ["--steps", "12", "--batch-size", "2",
                             "--data-size", "32", "--trace",
                             str(tmp_path / "tr"), "--log", str(log),
                             "--prefetch", "2"])
    assert rec["trace_steps"] == 6        # steps 5-10
    assert json.loads(open(rec["trace_path"]).read())["traceEvents"]
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert [x["step"] for x in lines] == list(range(12))
    out = capsys.readouterr().out
    assert "done:" in out and "tokens/s" in out
    assert rec["prefetch_worker_ms_per_batch"] > 0


def _jax_elastic_message() -> str:
    """The text the JAX example exits with on ``--elastic`` without
    ``--save`` (its ``__main__`` block)."""
    src = open(jex.__file__).read()
    return re.search(r'raise SystemExit\("(--elastic[^"]*)"\)', src).group(1)


@pytest.mark.parametrize("flag,item", [
    # --elastic is ported (ROADMAP.md Queue A item 6): beside
    # --sharded-ckpt with --save it runs; without --save it exits
    pytest.param(["--sharded-ckpt", "--elastic", "1"], "item 6",
                 id="flag1-item 6"),
    pytest.param(["--elastic", "2"], "item 6", id="flag2-item 6")])
def test_unported_flags_raise(flag, item, tmp_path):
    from distributed_pytorch_tpu_torch.utils.checkpoint import latest_step
    if "--sharded-ckpt" not in flag:
        with pytest.raises(SystemExit, match=re.escape(
                _jax_elastic_message())):
            train_transformer_lm.main(ARGS + CPU + flag)
        return
    ck = str(tmp_path / "ck")
    train_transformer_lm.main(ARGS + CPU + flag + ["--save", ck,
                                                   "--save-every", "4"])
    assert latest_step(ck) == 7
    with open(tmp_path / "ck" / "step_7" / "manifest.json") as f:
        assert json.load(f)["format"] == 2
