"""The port's governed runners over a mesh of gloo ranks against the JAX
package's on its 2-device CPU mesh.

One spawn of a (2, 1) gloo mesh (``tests/torch_mesh_ranks.py``) runs every
case of this file, each rank with its own governor and a budget of the same
limit, every rank passing the same host tables:

- governed q97 and q5 under a budget below their working set: the answer,
  the executions of the plan (one per piece) and the plan's retry stats equal
  the JAX runners' under the same limit, on both ranks;
- a SplitAndRetryOOM injected on rank 1 only: the admission outcome is agreed
  across the data axis, so both ranks split (two executions each, the answer
  exact) and rank 0 is not left alone in a collective.  The spawn is bounded
  at 120 s: a rank waiting alone would fail it;
- adaptive admission with a pre-split hint that rank 1 alone holds: the
  ranks agree on the deepest hint, so both start split.
"""

import jax
import numpy as np
import pytest

from spark_rapids_jni_tpu import mem as jax_mem
from spark_rapids_jni_tpu.models import q5 as jax_q5
from spark_rapids_jni_tpu.models import q97 as jax_q97
from spark_rapids_jni_tpu.parallel import make_mesh as jax_make_mesh
from spark_rapids_jni_tpu.plans import plan_cache as jax_plan_cache
from spark_rapids_jni_tpu.plans import runtime as jax_runtime
from spark_rapids_jni_tpu_torch.models import q5
from spark_rapids_jni_tpu_torch.models.q97 import Q97Batch, q97_host_oracle, q97_working_set_bytes
from spark_rapids_jni_tpu_torch.models.tpcds import generate_q5_data
from spark_rapids_jni_tpu_torch.plans import plan_working_set_bytes
from torch_mesh_ranks import run_ranks

SHAPE = (2, 1)
Q97_CAPACITY = 2048  # all of a sender's rows, whole or split: no grow
Q5_CASE = (0.05, 8)  # (sf, seed)
TIMEOUT_S = 120


def _q97_tables():
    rng = np.random.RandomState(9)
    return {"s_cust": rng.randint(1, 500, 1500).astype(np.int32),
            "s_item": rng.randint(1, 20, 1500).astype(np.int32),
            "c_cust": rng.randint(1, 500, 1200).astype(np.int32),
            "c_item": rng.randint(1, 20, 1200).astype(np.int32)}


def _q97_limit(t):
    full = q97_working_set_bytes(
        Q97Batch(t["s_cust"], t["s_item"], t["c_cust"], t["c_item"], capacity=Q97_CAPACITY),
        SHAPE[0])
    return int(full * 0.55)


def _q5_limit():
    plan, tables = q5._plan_and_tables(generate_q5_data(sf=Q5_CASE[0], seed=Q5_CASE[1]))
    return int(plan_working_set_bytes(plan, tables, SHAPE[0]) * 0.6)


def _cases():
    """label -> (job, inputs, keyword arguments)."""
    t = _q97_tables()
    q97_kw = {"limit": _q97_limit(t), "capacity": Q97_CAPACITY}
    q5_kw = {"limit": _q5_limit(), "sf": Q5_CASE[0], "seed": Q5_CASE[1]}
    return {
        "q97_tight": ("governed_q97", t, q97_kw),
        "q97_split_on_rank1": ("governed_q97", t, {"limit": 1 << 30, "capacity": Q97_CAPACITY,
                                                   "split_on_rank": 1}),
        "q5_tight": ("governed_q5", {"_": np.zeros(1)}, q5_kw),
        "q5_split_on_rank1": ("governed_q5", {"_": np.zeros(1)},
                              {**q5_kw, "limit": 1 << 30, "split_on_rank": 1}),
        "q5_presplit_on_rank1": ("governed_q5", {"_": np.zeros(1)},
                                 {**q5_kw, "limit": 1 << 30, "presplit_on_rank": 1}),
    }


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jobs = [(label, job, inputs, kw) for label, (job, inputs, kw) in _cases().items()]
    return run_ranks(SHAPE, jobs, tmp_path_factory.mktemp("governedranks"),
                     timeout_s=TIMEOUT_S)


def _jax(label):
    """The JAX runner of case ``label`` on the 2-device CPU mesh under a
    budget of the same limit: (answer, arbiter splits, executions, the
    plan's split_retries and runs)."""
    job, t, kw = _cases()[label]
    mesh = jax_make_mesh(SHAPE, devices=jax.devices()[:SHAPE[0]])
    gov = jax_mem.MemoryGovernor(watchdog_period_s=0.02)
    try:
        budget = jax_mem.BudgetedResource(gov, kw["limit"])
        jax_runtime.reset_plan_retry_stats()
        before = jax_plan_cache.stats()["execute_calls"]
        with jax_mem.task_context(gov, 1):
            if kw.get("split_on_rank", -1) >= 0:
                gov.force_split_and_retry_oom(num_ooms=1)
            if job == "governed_q97":
                out = jax_q97.run_distributed_q97(
                    mesh, (t["s_cust"], t["s_item"]), (t["c_cust"], t["c_item"]),
                    budget=budget, task_id=1, capacity=kw["capacity"], manage_task=False)
                answer = [out.store_only, out.catalog_only, out.both]
            else:
                rows = jax_q5.run_distributed_q5(
                    mesh, generate_q5_data(sf=kw["sf"], seed=kw["seed"]), budget=budget,
                    task_id=1, manage_task=False)
                answer = [(f"{r.channel}|{r.id}", tuple(r[2:])) for r in rows]
            splits = gov.get_and_reset_num_split_retry(1)
        assert budget.used == 0
        st = jax_runtime.plan_retry_stats().get("q5", {})
        return (answer, splits, jax_plan_cache.stats()["execute_calls"] - before,
                [st.get("split_retries"), st.get("runs")])
    finally:
        gov.close()


def _answer(out, job):
    if job == "governed_q97":
        return [int(x) for x in out["counts"]]
    return [(str(k), tuple(int(x) for x in v)) for k, v in zip(out["keys"], out["values"])]


@pytest.mark.parametrize("label", ["q97_tight", "q5_tight"])
def test_governed_under_a_tight_budget_matches_jax_on_every_rank(ranks, label):
    job = _cases()[label][0]
    answer, jax_splits, jax_execs, jax_plan_stats = _jax(label)
    assert jax_splits >= 1 and jax_execs >= 2, "the budget must force a split"
    for r in ranks:
        out = r[label]
        assert _answer(out, job) == answer
        assert int(out["executions"]) == jax_execs
        assert int(out["used"]) == 0
        if job == "governed_q5":
            assert out["plan_stats"].tolist() == jax_plan_stats


@pytest.mark.parametrize("label", ["q97_split_on_rank1", "q5_split_on_rank1"])
def test_split_injected_on_one_rank_splits_both(ranks, label):
    job, t, _ = _cases()[label]
    answer, jax_splits, jax_execs, _ = _jax(label)
    assert (jax_splits, jax_execs) == (1, 2)  # one split, two pieces, no grow
    # the arbiter signalled rank 1 only; rank 0 split on the agreed outcome
    assert [int(r[label]["splits"]) for r in ranks] == [0, 1]
    for r in ranks:
        out = r[label]
        assert _answer(out, job) == answer
        assert int(out["executions"]) == 2
        assert int(out["used"]) == 0
    if job == "governed_q97":
        assert tuple(answer) == q97_host_oracle((t["s_cust"], t["s_item"]),
                                                (t["c_cust"], t["c_item"]))


def test_presplit_hint_held_by_one_rank_presplits_both(ranks):
    """Each rank keeps its own retry history; the pre-split depth is agreed
    over the data axis, so the rank with no history starts split too."""
    answer, jax_splits, jax_execs, _ = _jax("q5_presplit_on_rank1")
    assert (jax_splits, jax_execs) == (0, 1)  # static JAX run: one piece
    for r in ranks:
        out = r["q5_presplit_on_rank1"]
        assert _answer(out, "governed_q5") == answer
        assert int(out["executions"]) == 2  # agreed depth 1: two halves each
        assert int(out["splits"]) == 0  # a pre-split, not an arbiter split
        assert int(out["used"]) == 0
    # [split_retries, runs]: rank 1's seeded history plus this run
    assert [r["q5_presplit_on_rank1"]["plan_stats"].tolist() for r in ranks] == [[0, 1], [1, 2]]
