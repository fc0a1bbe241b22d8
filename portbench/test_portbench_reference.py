"""The reference against the program at a tiny size on the CPU, in fp32:
the loss, every leaf's gradient, and the prefill's last logits."""

import pytest
import torch

from portbench import tiny, weights
from portbench.kinds.common import check_layout, port_config
from portbench.reference import model as ref

#: (cell, configuration overrides): the MoE, the dense model, and the dense
#: model within a sliding window shorter than the prompts (no cell has one
#: yet; a configuration file may set it)
CELLS = [("granite-moe-1b-a400m.train_4k", {}), ("h2o-danube-3-4b.prefill_long", {}),
         ("h2o-danube-3-4b.prefill_long", {"swa_window": 16})]
IDS = ["moe", "dense", "dense_window"]


def setup(workload, overrides=None, B=2, S=32, seed=5):
    from repro_torch.models.convert import flatten
    from repro_torch.models.registry import build

    c = tiny.cell(workload)
    c.cfg.update(overrides or {})
    api = build(port_config(c.cfg), "cpu")
    flat = dict(weights.draw(torch, c.cfg, seed, torch.device("cpu")))
    check_layout(flatten(api.abstract_params()), flat)
    tokens = torch.randint(0, c.cfg["vocab_size"], (B, S), generator=torch.Generator().manual_seed(seed))
    return c, api, flat, tokens


@pytest.mark.parametrize("workload,overrides", CELLS, ids=IDS)
def test_loss_and_gradients_match_the_program(workload, overrides):
    from repro_torch.runtime.steps import value_and_grad
    from repro_torch.models.convert import flatten

    c, api, flat, tokens = setup(workload, overrides)
    labels = torch.cat([tokens[:, 1:], torch.full((2, 1), -1)], 1)
    loss, _, grads = value_and_grad(api, weights.tree(flat), {"tokens": tokens, "labels": labels})
    leaves = {k: t.detach().clone().requires_grad_() for k, t in flat.items()}
    want, _ = ref.loss(leaves, tokens, labels, c.cfg)
    want.backward()
    assert float(loss) == pytest.approx(float(want), rel=1e-5)
    for k, g in flatten(grads).items():
        torch.testing.assert_close(g, leaves[k].grad, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("workload,overrides", CELLS, ids=IDS)
def test_last_logits_match_the_program(workload, overrides):
    from repro_torch.runtime.steps import make_prefill_step

    c, api, flat, tokens = setup(workload, overrides)
    logits, _ = make_prefill_step(api)(weights.tree(flat), {"tokens": tokens})
    torch.testing.assert_close(logits[:, -1], ref.last_logits(flat, tokens, c.cfg),
                               rtol=1e-4, atol=1e-5)


def test_the_capacity_drops_the_same_pairs_as_the_program():
    """Few slots: every expert overflows, and the outputs still agree."""
    from repro_torch.runtime.steps import make_prefill_step

    c, api, flat, tokens = setup("granite-moe-1b-a400m.train_4k")
    from repro_torch.models.registry import build

    c.cfg["moe"] = dict(c.cfg["moe"], capacity_factor=0.25)
    api = build(port_config(c.cfg), "cpu")
    logits, _ = make_prefill_step(api)(weights.tree(flat), {"tokens": tokens})
    torch.testing.assert_close(logits[:, -1], ref.last_logits(flat, tokens, c.cfg),
                               rtol=1e-4, atol=1e-5)
