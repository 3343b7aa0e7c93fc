"""The port's multi-host runtime (``spark_rapids_jni_tpu_torch/parallel/
multihost.py``) and the paths it carries across ranks, on gloo ranks on the
CPU, held against the JAX package.

- One process: ``initialize()`` is a no-op without a cluster environment,
  ``is_multihost()`` is False and ``process_summary()`` has the JAX keys;
  ``WORLD_SIZE=2`` without a reachable rendezvous, or a group of another
  size, raises; ``make_pod_mesh`` without a group raises.
- Two ranks launched as ``torchrun`` launches them (one spawn), joined
  through ``initialize``: q97 over ``make_pod_mesh(mp=1)`` on the inputs of
  ``tests/multihost_worker.py`` (512 rows, seed 11) equals JAX ``q97_local``;
  the NDS harness's ``main`` in memory and streamed (its host budget cut so
  that q97's buckets split on disk) gives, on both ranks, the JAX harness's
  counts at the same arguments; ``run_q97_monte_carlo(n_tasks=3, ndev=2)``
  is ok over three distinct data-axis groups.
- Four ranks on two nodes that interleave (``GROUP_RANK`` 0, 1, 0, 1):
  ``make_pod_mesh(mp=2)`` puts each node's ranks in one model group, with
  data indices ordered by node; ``mp=4`` straddles a node and raises.

Tolerance: exact (every answer is an integer).
"""

import contextlib
import io
import json

import jax.numpy as jnp
import pytest
import torch.distributed as dist

from spark_rapids_jni_tpu.models import nds_harness as jax_harness
from spark_rapids_jni_tpu.models.q97 import q97_local as jax_q97_local
from spark_rapids_jni_tpu.parallel import multihost as jax_multihost
from spark_rapids_jni_tpu_torch.parallel import (
    initialize_multihost,
    is_multihost,
    make_pod_mesh,
    multihost,
)

import torch_multihost_ranks as ranks

_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK",
               "MASTER_ADDR", "MASTER_PORT", "TORCHELASTIC_RUN_ID", "SLURM_JOB_ID",
               "OMPI_MCA_orte_hnp_uri")


@pytest.fixture
def no_launch(monkeypatch):
    for name in _LAUNCH_ENV:
        monkeypatch.delenv(name, raising=False)
    assert not dist.is_initialized()


def test_single_process_initialize_is_a_noop(no_launch):
    initialize_multihost()
    initialize_multihost(device="cpu")
    assert not dist.is_initialized()
    assert not is_multihost()
    summary = multihost.process_summary()
    assert summary.keys() == jax_multihost.process_summary().keys()
    assert summary == {"process_index": 0, "process_count": 1, "local_devices": 1,
                       "global_devices": 1}
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        make_pod_mesh(device="cpu")


def test_a_launch_without_its_ranks_raises(no_launch, monkeypatch, tmp_path):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="RANK"):
        initialize_multihost(device="cpu")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(ranks.free_port()))
    monkeypatch.setattr(multihost, "INIT_TIMEOUT_S", 2.0)
    with pytest.raises(RuntimeError):  # rank 1 never comes
        initialize_multihost(device="cpu")
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already up"):
            initialize_multihost(device="cpu")
        monkeypatch.setenv("WORLD_SIZE", "1")
        initialize_multihost(device="cpu")  # the expected size: accepted
        with pytest.raises(ValueError, match="does not divide"):
            make_pod_mesh(mp=2, device="cpu")
    finally:
        dist.destroy_process_group()


def _jax_harness(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = jax_harness.main(argv)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _counts(line):
    qs = line["queries"]
    return {"q97": qs["q97"]["counts"], "q5": qs["q5"]["result_rows"],
            "q3": qs["q3"]["result_rows"],
            "rows": [qs[q]["fact_rows"] for q in ("q5", "q97", "q3")]}


def test_two_launched_ranks_run_q97_the_harness_and_the_monte_carlo(tmp_path):
    got = ranks.launch("pair", tmp_path, [None, None])
    s_cust, s_item, c_cust, c_item = (jnp.asarray(a) for a in ranks.q97_inputs())
    want = jax_q97_local((s_cust, s_item), (c_cust, c_item))
    want_q97 = [int(want.store_only), int(want.catalog_only), int(want.both), 0]
    jax_mem = _counts(_jax_harness(ranks.harness_args(False)))
    jax_streamed = _counts(_jax_harness(ranks.harness_args(True)))
    for rank, out in enumerate(got):
        assert out["world"] == 2 and out["multihost"] is True
        assert out["summary"] == {"process_index": rank, "process_count": 2,
                                  "local_devices": 2, "global_devices": 2}
        assert out["q97"] == want_q97, f"rank {rank}"
        for key, line, ref in (("harness", out["harness"], jax_mem),
                               ("streamed", out["streamed"], jax_streamed)):
            assert line["rc"] == 0 and line["ndev"] == 2, (rank, key)
            assert all(q["verified"] is True for q in line["queries"].values()), (rank, key)
            assert _counts(line) == ref, (rank, key)
        streamed = out["streamed"]["queries"]["q97"]["streamed"]
        assert streamed["bucket_splits"] > 0, "the cut host budget must split a bucket"
        mc = out["monte_carlo"]
        assert mc["ok"], mc
        assert mc["tasks_completed"] == ranks.MC_TASKS and mc["data_groups"] == ranks.MC_TASKS
    assert got[0]["streamed"]["queries"]["q97"]["streamed"] == \
        got[1]["streamed"]["queries"]["q97"]["streamed"]


def test_pod_mesh_keeps_each_node_together(tmp_path):
    nodes = [0, 1, 0, 1]  # ranks 0 and 2 on node 0, 1 and 3 on node 1
    got = ranks.launch("pod_layout", tmp_path, nodes)
    for rank, out in enumerate(got):
        m2 = out["mp2"]
        assert m2["mesh"] == [[0, 2], [1, 3]]
        assert sorted(m2["model_group"]) == [r for r in range(4) if nodes[r] == nodes[rank]]
        assert m2["data_index"] == nodes[rank] == m2["coordinate"][0]
        assert m2["model_index"] == [0, 2, 1, 3].index(rank) % 2 == m2["coordinate"][1]
        assert sorted(m2["data_group"]) == [r for r in range(4)
                                            if [0, 2, 1, 3].index(r) % 2 == m2["model_index"]]
        m1 = out["mp1"]
        assert m1["mesh"] == [[0], [2], [1], [3]] and m1["model_group"] == [rank]
        assert m1["coordinate"] == [[0, 2, 1, 3].index(rank), 0]
        assert "does not divide the 2 ranks of node" in out["mp4"]
