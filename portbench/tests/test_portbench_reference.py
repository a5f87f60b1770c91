"""The plain reference against the port at a tiny GPT-2 on the CPU:
the same seed-made weights, the same rows, float32 on both sides."""

import pytest
import torch

from portbench import checks, program, traffic, weights as W
from portbench.drivers import train
from portbench.reference import gpt2 as ref
from portbench.tests import tiny


@pytest.fixture(scope="module")
def setup():
    torch.manual_seed(0)
    cfg = tiny.TINY
    w = W.make(cfg, 7, torch.device("cpu"), torch.float32)
    model = program.build_model(cfg, torch.device("cpu"), torch.float32)
    W.load_into_port(model, w)
    rows = torch.from_numpy(traffic.train_rows(tiny.TRAIN_MIX, cfg, 7)[:4])
    return cfg, w, model, rows


def test_weights_are_gpt2s_initialisation(setup):
    cfg, w, _, _ = setup
    assert set(w) == {n for n, _, _ in W.layout(cfg)}
    assert sum(t.numel() for t in w.values()) == W.n_params(cfg)
    assert w["wte"].std().item() == pytest.approx(0.02, rel=0.1)
    assert torch.all(w["h.0.ln_1.weight"] == 1)
    assert torch.all(w["h.1.mlp.c_fc.bias"] == 0)
    again = W.make(cfg, 7, torch.device("cpu"), torch.float32)
    assert all(torch.equal(w[n], again[n]) for n in w)


def test_logits(setup):
    cfg, w, model, rows = setup
    x = rows[:, :-1]
    with torch.no_grad():
        got = model(x)
    want = ref.logits(w, cfg, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_loss_and_every_gradient(setup):
    cfg, w, model, rows = setup
    x, y = rows[:, :-1], rows[:, 1:]
    model.zero_grad()
    loss, _ = train.lm_loss(model, (x, y))
    loss.backward()
    p = {n: t.clone().requires_grad_() for n, t in w.items()}
    rloss = ref.loss(p, cfg, x, y)
    grads = torch.autograd.grad(rloss, list(p.values()))
    torch.testing.assert_close(loss, rloss, rtol=1e-6, atol=1e-6)
    params = dict(model.named_parameters())
    for (name, _), g in zip(p.items(), grads):
        target, transposed = W.port_name(name)
        got = params[target].grad
        torch.testing.assert_close(got.t() if transposed else got, g,
                                   rtol=1e-4, atol=1e-6, msg=name)


def test_three_adamw_steps(setup):
    """The port's AdamW under its f32 step (no bf16 policy) follows the
    reference's three steps: losses, gradient norms, change norms."""
    cfg, w, _, _ = setup
    mix = dict(tiny.TRAIN_MIX)
    cfg32 = dict(cfg, assumed=dict(cfg["assumed"], train=dict(
        cfg["assumed"]["train"], mixed_precision="off")))
    r = type("R", (), {"config": cfg32, "mix": mix, "seed": 7,
                       "device": "cpu", "t_start": 0.0})()
    tr = train.Trainer(r)
    prog = tr.checked_steps(mix["checked_steps"])
    tr.free()
    want = train.reference_readings(r)
    for a, b in zip(prog["losses"], want["losses"], strict=True):
        assert a == pytest.approx(b[0], rel=1e-5)
    # the key bias's gradient is nought under softmax: it moves by
    # round-off alone, and the checks leave it out of the change
    moving = checks.moving_leaves(want["grad_norms"])
    assert len(moving) == len(want["grad_norms"]) - cfg["n_layer"]
    for key, names in (("grad_norms", want["grad_norms"]),
                       ("change_norms", moving)):
        assert set(prog[key]) == set(want[key])
        for n in names:
            assert prog[key][n] == pytest.approx(want[key][n], rel=2e-3,
                                                 abs=1e-7), (key, n)
