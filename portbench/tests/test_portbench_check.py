"""The check that decides ``correct``, driven through a whole serve run on
the host at a small size (the look for a card skipped), under each cell's
own check (its limits and ``wrong_gap``; fewer served tokens): a sound run
is correct, and a run whose served tokens are altered where the program
produces them is not. On the card, ``test_portbench_control_cuda`` holds
the cells' own limits between the program and the fp8 control."""
import time

import pytest
import torch

from portbench import faults, spec
from portbench.kinds import serve
from portbench.reference import decoder, judge


def _own_check(config):
    bench = spec.load_benchmark()
    return dict(spec.config(bench, config)["check"], served_tokens=30)


DENSE = {"name": "tiny-dense", "model": {
    "family": "dense", "num_layers": 2, "d_model": 64, "num_heads": 4,
    "num_kv_heads": 1, "d_ff": 128, "vocab_size": 256, "head_dim": 16,
    "rope_theta": 10000.0, "dtype": "bfloat16"},
    "engine": {"batch": 4, "max_seq": 256, "kv_pool_blocks": 40},
    "check": _own_check("granite-20b")}
MOE = {"name": "tiny-moe", "model": {
    "family": "moe", "num_layers": 3, "d_model": 64, "num_heads": 4,
    "num_kv_heads": 4, "d_ff": 64, "vocab_size": 256, "head_dim": 16,
    "num_experts": 8, "experts_per_token": 2, "num_shared_experts": 1,
    "moe_d_ff": 32, "first_k_dense": 1, "capacity_factor": 1.25,
    "rope_theta": 10000.0, "dtype": "bfloat16"},
    "engine": {"batch": 4, "max_seq": 256},
    "check": _own_check("deepseek-moe-16b")}
SHARED = {"kind": "serve", "clients": 4, "shape_seed": 1, "sessions": 4000,
          "turns": 3, "corpus": {"documents": 6, "doc_tokens": [40, 150],
                                 "zipf_s": 1.0},
          "question_tokens": [8, 30], "answer_tokens": [4, 12],
          "lead_in_steps": 6}
UNIQUE = {"kind": "serve", "clients": 4, "shape_seed": 2, "sessions": 4000,
          "turns": 1, "prompt_tokens": [20, 120], "answer_tokens": [4, 12],
          "lead_in_steps": 6}
CELLS = {"dense": (DENSE, SHARED), "moe": (MOE, UNIQUE)}
#: the number of each cell's check that a token altered has to fail: one
#: wrong token moves the MoE cell's mean gap too little
CAUGHT_BY = {"dense": "max_logit_gap", "moe": "wrong_tokens"}


def _run(cfg, mix, seed):
    return serve.run(cfg, mix, seed, 3.0, trace_on=False, device="cpu",
                     t0=time.perf_counter())


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(cell):
    rec = _run(*CELLS[cell], 2 ** 31 + 11)
    assert rec["correct"], rec["checks"]
    assert rec["attempted"] > 0 and rec["failed"] == 0


@pytest.mark.parametrize("fault", faults.PLACES)
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_token_altered_where_it_is_produced_fails(cell, fault):
    cfg, mix = CELLS[cell]
    with faults.altered(fault, cfg["model"]["vocab_size"]):
        rec = _run(cfg, mix, 5)
    assert not rec["correct"]
    v = rec["checks"][CAUGHT_BY[cell]]
    assert v["value"] > v["limit"]


def test_one_wrong_token_fails_the_moe_cell_that_its_mean_gap_passes():
    check = spec.config(spec.load_benchmark(), "deepseek-moe-16b")["check"]
    g = torch.zeros(check["served_tokens"])
    g[7] = 4.0                        # a wrong token, every other exact
    cmp = {**judge.summary(g, wrong_gap=check["wrong_gap"]),
           "tokens": g.numel()}
    assert cmp["mean_logit_gap"] <= check["limits"]["mean_logit_gap"]
    correct, checks = serve.verdict(cmp, check, unfinished=0)
    assert not correct and checks["wrong_tokens"]["value"] == 1


def test_the_control_is_judged_by_the_same_verdict_as_the_program():
    check = {"served_tokens": 3, "limits": {"max_logit_gap": 0.25}}
    cmp = {"tokens": 3, "max_logit_gap": 0.1, "control_max_logit_gap": 0.7}
    assert serve.verdict(cmp, check, 0)[0]
    correct, checks = serve.verdict(cmp, check, 0, "control_")
    assert not correct
    assert checks["max_logit_gap"] == {"value": 0.7, "limit": 0.25}


def test_reference_capacity_drops_the_later_choices_of_a_full_expert():
    ids = torch.tensor([[0, 1], [0, 2], [0, 1], [3, 0]])
    keep = decoder.kept_choices(ids, n_group=4, cap=2)
    # expert 0 is chosen 4 times (tokens 0, 1, 2, 3): the last two drop;
    # expert 1 twice, kept
    assert keep.tolist() == [[True, True], [True, True], [False, True],
                             [True, False]]
    # a token after the group routes alone: nothing drops
    assert decoder.kept_choices(ids, n_group=0, cap=1).all()


def test_gap_is_zero_for_the_reference_choice():
    ref = torch.tensor([[0.0, 3.0, 1.0], [2.0, -1.0, 2.5]])
    got = judge.gaps(ref, torch.tensor([1, 0]))
    assert got.tolist() == [0.0, 0.5]
