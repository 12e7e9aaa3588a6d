"""The port's host-object collectives (``utils/multihost.py``) at 8 ranks.

tests/test_multihost.py's checks (``gather_objects`` ordered by rank and
ragged, ``broadcast_object``, ``sync_hosts``) in one spawn of 8 gloo ranks
(``torch_parallel_ranks.multihost``), which then runs ``run_cot`` over the
8 ranks on the tiny pipeline (``build_pipeline("tiny")``); its rating table must equal the one this
process computes alone. One process makes every helper the identity.
"""
import json
import os

import pytest
import torch

import torch_parallel_ranks as R
from unigen_tpu_torch.launch import build_pipeline
from unigen_tpu_torch.evaluation.cot import run_cot
from unigen_tpu_torch.utils import multihost as MH

PROMPTS = ["a photo of a red cup and a blue bench", "a photo of a cup", "a strange prompt"]
COT_KW = dict(n_samples=2, topk=1, guidance_scale=2.0, timesteps=2, eval_text_len=6,
              max_new_tokens=3)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("multihost"))
    pipe = build_pipeline("tiny", device="cpu")
    inputs = dict(pipeline=pipe, prompts=PROMPTS, kw=dict(seed=0, **COT_KW))
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    R.spawn("multihost", 8, os.path.join(tmp, "inputs.pt"), tmp)
    out = torch.load(os.path.join(tmp, "multihost.pt"), weights_only=False)
    return out, run_cot(pipe, PROMPTS, 0, **COT_KW)


def test_one_process_is_the_identity():
    assert MH.process_index() == 0 and MH.process_count() == 1
    assert MH.gather_objects({"a": 1}) == [{"a": 1}]
    assert MH.broadcast_object([1, 2]) == [1, 2]
    MH.sync_hosts()


@pytest.mark.parametrize("check", ["gather", "ragged", "broadcast", "every_rank"])
def test_collectives_at_8_ranks(ranks, check):
    everyone = ranks[0]["ranks"]
    assert [e["rank"] for e in everyone] == list(range(8))
    for e in everyone:
        assert e["count"] == 8
        if check == "gather":
            assert e["gather"] == [{"rank": r, "rows": [r * 10, r * 10 + 1]} for r in range(8)]
        elif check == "ragged":
            assert e["ragged"] == [["x"] * (r % 3 + 1) for r in range(8)]
        elif check == "broadcast":
            assert e["bcast0"] == {"cfg": [1, 2, 3]} and e["bcast_last"] == "from 7"
    if check == "every_rank":     # every rank got the same gathered lists
        assert all(e["gather"] == everyone[0]["gather"] for e in everyone)


def test_run_cot_rating_table_equal_at_8_ranks_and_1(ranks):
    """Each prompt's generators come from (seed, prompt index), so the
    sharded run rates as the single process does; rank 0's gathered table
    (and its stats) equal the one-process run's."""
    (_, table, stats), (_, want_table, want_stats) = ranks[0]["cot"], ranks[1]
    assert table and len(table) == len(want_table)
    assert sorted(map(json.dumps, table)) == sorted(map(json.dumps, want_table))
    assert sorted(map(json.dumps, stats)) == sorted(map(json.dumps, want_stats))
