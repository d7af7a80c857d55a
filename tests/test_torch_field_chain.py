"""The port's field squaring chain (plenum_tpu_torch.ops.field_chain, K8's
plain version) against the JAX package: its `_pow2k`, the Pallas probe's
own squaring body (`_sqr_limb_major`, probes/pallas_sqr_experiment.py)
and Python's `pow`.

The reference's chains return carried 13-bit limbs, the port's canonical
ones, so values are compared mod p: exactly, as integers. K8 itself is
held against the plain version on the card (marked `gpu`).
"""
import importlib.util
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plenum_tpu.ops import ed25519 as ref
from plenum_tpu_torch import ops
from plenum_tpu_torch.ops.field_chain import field_chain, field_chain_torch

P = ref.P
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _probe():
    spec = importlib.util.spec_from_file_location(
        "pallas_sqr_experiment",
        os.path.join(ROOT, "probes", "pallas_sqr_experiment.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _values(n, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n - 4)]
    return vals + [0, 1, P - 1, 2**255 - 20]


def _limb_major(vals):
    """[20, N] int32, the probe's layout."""
    return np.ascontiguousarray(np.stack([ref.int_to_limbs(v) for v in vals]).T)


def _col_ints(x):
    x = np.asarray(x)
    return [ref.limbs_to_int(x[:, j]) % P for j in range(x.shape[1])]


@pytest.mark.parametrize("k", [0, 1, 7, 64])
def test_chain_matches_python_pow(k):
    vals = _values(16, k)
    got = field_chain(torch.from_numpy(_limb_major(vals)), k)
    assert got.shape == (20, 16) and got.dtype == torch.int32
    assert _col_ints(got.numpy()) == [pow(v, 2**k, P) for v in vals]
    # canonical 13-bit limbs on the way out
    assert int(got.min()) >= 0 and int(got.max()) < 8192


def test_chain_matches_jax_pow2k():
    vals = _values(16, 5)
    x = _limb_major(vals)
    got = field_chain(torch.from_numpy(x), 64)
    want = np.asarray(ref._pow2k(jnp.asarray(x.T), 64))       # [N, 20]
    assert _col_ints(got.numpy()) == _col_ints(want.T)


def test_chain_matches_the_pallas_probes_body():
    """The probe's squaring body (the pl.pallas_call's kernel, run as
    plain jax.numpy here) iterated k = 3 times."""
    probe = _probe()
    vals = _values(8, 9)
    x = _limb_major(vals)
    want = jnp.asarray(x)
    for _ in range(3):
        want = probe._sqr_limb_major(want)
    got = field_chain(torch.from_numpy(x), 3)
    assert _col_ints(got.numpy()) == _col_ints(want)


def test_chain_takes_carried_limbs():
    """Inputs in carried form — limbs in [-2, 2^13 + 3], here the
    reference's own carried output — give the same values."""
    vals = _values(8, 13)
    carried = np.asarray(ref.f_sqr(jnp.asarray(_limb_major(vals).T))).T
    carried = np.ascontiguousarray(carried)
    assert carried.min() >= -2 and carried.max() <= 8195
    got = field_chain_torch(torch.from_numpy(carried), 2)
    assert _col_ints(got.numpy()) == [pow(v, 8, P) for v in vals]


def test_cpu_tensors_launch_nothing_and_shapes_are_checked():
    before = dict(ops.LAUNCHES)
    field_chain(torch.zeros((20, 4), dtype=torch.int32), 3)
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError):
        field_chain(torch.zeros((10, 4), dtype=torch.int32), 3)
    with pytest.raises(ValueError):
        field_chain(torch.zeros((20, 4), dtype=torch.int64), 3)


@pytest.mark.parametrize("per_item, per_block", [
    (3, 32), (0, 32), (8, 32), (4, 48), (2, 32), (1, 0), (4, 256)])
def test_geometry_is_checked(per_item, per_block):
    """1 or 4 lanes a column in blocks of whole warps up to 128
    threads; anything else raises before any launch."""
    with pytest.raises(ValueError, match="lanes per column"):
        field_chain(torch.zeros((20, 4), dtype=torch.int32), 3, per_item,
                    per_block)


@pytest.mark.parametrize("n", [1, 3, 31, 33, 1025, 2049])
def test_plain_version_at_ragged_widths(n):
    """The widths that leave a group, a warp and a block partly filled on
    the card: the plain version against Python's pow, k = 0, 1, 254."""
    vals = _values(n, 100 + n) if n >= 4 else [P - 1, 2, 2**255 - 20][:n]
    x = torch.from_numpy(_limb_major(vals))
    for k in (0, 1, 254):
        got = field_chain_torch(x, k).numpy()
        assert int(got.min()) >= 0 and int(got.max()) < 8192
        assert _col_ints(got) == [pow(v, 2**k, P) for v in vals]


_HOST_HARNESS = r"""
#include "ed25519.cu"
#include <thread>
#include <vector>
// K8 per column as the card runs it: one thread, or four host threads
// as the lanes of one quad (HostLanes: a barrier for each shuffle)
extern "C" void host_field_chain(const int32_t* x, int32_t* out, int n,
                                 int k, int g) {
  for (int i = 0; i < n; ++i) {
    if (g == 1) {
      field_chain_one(x + i, out + i, n, k);
      continue;
    }
    std::barrier<> meet(g);
    HostLanesSlots slots{{}, &meet};
    std::vector<std::thread> lanes;
    for (int l = 0; l < g; ++l)
      lanes.emplace_back([&, l] {
        HostLanes xc{l, &slots};
        field_chain_lanes(xc, x + i, out + i, n, k);
      });
    for (auto& t : lanes) t.join();
  }
}
"""


def test_lane_groups_match_the_plain_version_as_host_cpp(tmp_path):
    """csrc/ed25519.cu's K8 functions built as host C++ (g++), a group's
    lanes as host threads: one thread and a quad per column give the
    plain version's limbs."""
    import ctypes
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    src = tmp_path / "k8.cpp"
    src.write_text(_HOST_HARNESS)
    so = tmp_path / "libk8.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-pthread", "-I", os.path.join(
                        ROOT, "plenum_tpu_torch", "csrc"),
                    "-o", str(so), str(src)], check=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    lib.host_field_chain.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + \
        [ctypes.c_int] * 3
    for n in (1, 3, 5):
        x = _limb_major(_values(n + 4, n)[-n:])
        x[:, 0] = 8195                 # carried-form extremes in column 0
        if n > 1:
            x[:, 1] = -2
        for k in (0, 1, 254):
            want = field_chain_torch(torch.from_numpy(x), k).numpy()
            for g in (1, 4):
                out = np.zeros_like(x)
                lib.host_field_chain(x.ctypes.data, out.ctypes.data, n, k, g)
                assert np.array_equal(out, want), (n, k, g)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_card(cuda_device):
    x = torch.from_numpy(_limb_major(_values(2048, 3)))
    before = ops.LAUNCHES["field_chain"]
    got = field_chain(x.to(cuda_device), 64)
    assert ops.LAUNCHES["field_chain"] == before + 1
    assert torch.equal(got.cpu(), field_chain_torch(x, 64))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 31, 33, 1025, 2049])
def test_kernel_at_ragged_widths_on_card(cuda_device, n):
    """Every geometry (1 or 4 lanes a column; 32, 64, 128 threads a
    block) at k = 0, 1, 254, one launch a call, against the plain
    version; a strided view is refused."""
    x = torch.from_numpy(_limb_major(_values(n + 4, n)[-n:]))
    xd = x.to(cuda_device)
    for k in (0, 1, 254):
        want = field_chain_torch(x, k)
        for g in (1, 4):
            for b in (32, 64, 128):
                before = ops.LAUNCHES["field_chain"]
                got = field_chain(xd, k, g, b)
                assert ops.LAUNCHES["field_chain"] == before + 1
                assert torch.equal(got.cpu(), want)
    with pytest.raises(ValueError):
        field_chain(torch.cat([xd, xd], 1)[:, ::2], 1)
