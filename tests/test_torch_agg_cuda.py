"""The kernel library's build under concurrent first calls (CPU), and the
``srt_segment_sum`` kernel against its plain version (card only).

The build test stubs nvcc with a slow writer of its output file and calls
``_build.library()`` from four threads at once, as four task threads make
their first kernel call: one build, one loaded library, no error.

The ``cuda``-marked tests skip without a card.  On a machine with one:

    python -m pytest -m cuda tests/test_torch_agg_cuda.py -q

No JAX here: the card's results are held to ``segment_sum_torch`` on the
same card tensors, bit for bit (float values are quarters whose sums are
exact in any order).
"""

import threading
import time
from types import SimpleNamespace

import pytest
import torch

from spark_rapids_jni_tpu_torch.ops import _build, agg_cuda, hash_cuda


def test_library_builds_and_loads_once_under_four_concurrent_first_calls(monkeypatch, tmp_path):
    builds, loads = [], []

    def slow_nvcc(cmd, capture_output, text):
        out = cmd[cmd.index("-o") + 1]
        builds.append(out)
        with open(out, "wb") as f:
            for _ in range(5):
                f.write(b"\0" * 64)
                f.flush()
                time.sleep(0.05)
        return SimpleNamespace(returncode=0, stdout="", stderr="")

    def cdll(path):
        loads.append(path)
        return SimpleNamespace(**{name: SimpleNamespace() for name in _build._SIGNATURES})

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", slow_nvcc)
    monkeypatch.setattr(_build.ctypes, "CDLL", cdll)
    monkeypatch.setattr(_build, "_library", None)

    start = threading.Barrier(4)
    got, errors = [None] * 4, []

    def first_call(k):
        start.wait()
        try:
            got[k] = _build.library()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=first_call, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert len(builds) == 1 and len(loads) == 1
    assert all(g is got[0] for g in got)
    assert loads[0] == str(_build.library_path())
    assert _build.library_path().stat().st_size == 5 * 64
    assert list((tmp_path / "kernels").iterdir()) == [_build.library_path()]
    assert got[0].srt_segment_sum.argtypes == list(_build._SIGNATURES["srt_segment_sum"])


def test_library_path_covers_every_source():
    assert {p.name for p in _build.SOURCES} == {"hash_kernels.cu", "agg_kernels.cu"}
    assert all(p.is_file() for p in _build.SOURCES)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: srt_segment_sum runs on a card only")
    hash_cuda.reset_launches()
    return torch.device("cuda")


# grids on both of the kernel's paths: shared memory up to 48 KB, global atomics above
@pytest.mark.cuda
@pytest.mark.parametrize("num_segments", [1, 6, 6144, 12_288, 65_536, 201_000])
@pytest.mark.parametrize("value_dtype", [torch.int32, torch.int64, torch.float32,
                                         torch.float64])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_kernel_equals_plain_version_on_the_card(card, id_dtype, value_dtype, num_segments):
    g = torch.Generator(device=card)
    g.manual_seed(num_segments)
    n = (1 << 20) + 37  # a ragged tail past the unrolled loop
    ids = torch.randint(-3, num_segments + 3, (n,), generator=g, device=card, dtype=id_dtype)
    ids = torch.where(torch.rand((n,), generator=g, device=card) < 0.5, -1, ids)
    if value_dtype.is_floating_point:
        # quarters of at most 2 in size: every partial sum of a million is
        # exact in float32, so any order of adding gives the same bits
        vals = torch.randint(-8, 9, (n,), generator=g, device=card).to(value_dtype) / 4
    else:
        vals = torch.randint(-(1 << 30), 1 << 30, (n,), generator=g, device=card,
                             dtype=value_dtype)
    got = agg_cuda.segment_sum(vals, ids, num_segments)
    want = agg_cuda.segment_sum_torch(vals, ids, num_segments)
    torch.cuda.synchronize()
    assert hash_cuda.launches["segment_sum"] == 1
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_skips_every_row_when_all_are_dropped_and_wraps_int64(card):
    n = 1 << 22
    ids = torch.full((n,), -1, dtype=torch.int32, device=card)
    vals = torch.full((n,), (1 << 62), dtype=torch.int64, device=card)
    assert torch.equal(agg_cuda.segment_sum(vals, ids, 201_000),
                       torch.zeros(201_000, dtype=torch.int64, device=card))
    ids.zero_()
    assert int(agg_cuda.segment_sum(vals, ids, 1)[0]) == 0  # 2**22 x 2**62 wraps to 0
    ids[:3] = 0
    ids[3:] = 7
    assert int(agg_cuda.segment_sum(vals, ids, 1)[0]) == (3 << 62) - (1 << 64)
    assert hash_cuda.launches["segment_sum"] == 3


@pytest.mark.cuda
def test_empty_inputs_and_grids_launch_nothing(card):
    empty = torch.empty(0, dtype=torch.int64, device=card)
    assert agg_cuda.segment_sum(empty, empty, 5).tolist() == [0] * 5
    one = torch.ones(4, dtype=torch.int64, device=card)
    assert agg_cuda.segment_sum(one, one, 0).numel() == 0
    assert hash_cuda.launches["segment_sum"] == 0


@pytest.mark.cuda
def test_kernel_branch_refuses_other_dtypes_and_strided_inputs_before_launching(card):
    ids = torch.zeros(64, dtype=torch.int32, device=card)
    with pytest.raises(TypeError, match="int32, int64, float32 or float64"):
        agg_cuda.segment_sum(torch.ones(64, dtype=torch.int8, device=card), ids, 6)
    with pytest.raises(ValueError, match="contiguous"):
        agg_cuda.segment_sum(torch.ones(128, dtype=torch.int64, device=card)[::2], ids, 6)
    assert hash_cuda.launches["segment_sum"] == 0
