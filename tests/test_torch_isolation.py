"""The port stands alone: no module of plenum_tpu_torch (nor chip_smoke.py)
imports jax or anything of the JAX package plenum_tpu."""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "plenum_tpu_torch")


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")] if mod.endswith(".__init__")
                            else mod)
    return sorted(mods)


_BLOCKER = r'''
import importlib, importlib.abc, sys

class Blocked(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "plenum_tpu"):
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, Blocked())
for mod in sys.argv[1:]:
    importlib.import_module(mod)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "plenum_tpu"))
assert not loaded, loaded
print("imported", len(sys.argv) - 1)
'''


def test_every_module_imports_with_jax_and_reference_blocked():
    mods = _port_modules()
    assert "plenum_tpu_torch.ops.ed25519" in mods and len(mods) >= 20
    assert {"plenum_tpu_torch.ops.field_chain", "plenum_tpu_torch.parallel",
            "plenum_tpu_torch.parallel.mesh", "plenum_tpu_torch.graft_entry",
            "plenum_tpu_torch.parallel.crypto_plane",
            "plenum_tpu_torch.state", "plenum_tpu_torch.state.commitment",
            "plenum_tpu_torch.state.commitment.kzg",
            "plenum_tpu_torch.execution", "plenum_tpu_torch.execution.handlers",
            "plenum_tpu_torch.native", "plenum_tpu_torch.crypto.bls",
            "plenum_tpu_torch.consensus.bls_bft_replica",
            "plenum_tpu_torch.node.bootstrap",
            "plenum_tpu_torch.tools.local_pool",
            "plenum_tpu_torch.node.node", "plenum_tpu_torch.network.sim_network",
            "plenum_tpu_torch.consensus.ordering_service",
            "plenum_tpu_torch.catchup.leecher", "plenum_tpu_torch.reads.plane",
            "plenum_tpu_torch.client.client",
            "plenum_tpu_torch.observability.aggregator",
            "plenum_tpu_torch.parallel.crypto_service",
            "plenum_tpu_torch.tools.trace_report",
            "plenum_tpu_torch.network.tcp_stack",
            "plenum_tpu_torch.node.looper", "plenum_tpu_torch.node.recorder",
            "plenum_tpu_torch.node.observer_node", "plenum_tpu_torch.ingress",
            "plenum_tpu_torch.ingress.controller",
            "plenum_tpu_torch.ingress.plane",
            "plenum_tpu_torch.ingress.observer_reads",
            "plenum_tpu_torch.tools.start_node",
            "plenum_tpu_torch.tools.tcp_pool",
            "plenum_tpu_torch.tools.keygen", "plenum_tpu_torch.tools.genesis",
            "plenum_tpu_torch.tools.metrics_report",
            "plenum_tpu_torch.tools.log_analyzer",
            "plenum_tpu_torch.tools.replay",
            "plenum_tpu_torch.tools.start_observer",
            "plenum_tpu_torch.tools.perf_sentinel",
            "plenum_tpu_torch.tools.metrics_lint",
            "plenum_tpu_torch.tools.fleet_console",
            "plenum_tpu_torch.tools.fuzz_lint",
            "plenum_tpu_torch.tools.churn_soak",
            "plenum_tpu_torch.tools.soak",
            "plenum_tpu_torch.tools.micro_costs",
            "plenum_tpu_torch.tools.perf_budget",
            "plenum_tpu_torch.parallel.federation",
            "plenum_tpu_torch.parallel.multihost",
            "plenum_tpu_torch.parallel.pipeline",
            "plenum_tpu_torch.shards", "plenum_tpu_torch.shards.mapping",
            "plenum_tpu_torch.shards.router",
            "plenum_tpu_torch.shards.read_client",
            "plenum_tpu_torch.shards.reshard",
            "plenum_tpu_torch.shards.cross_write",
            "plenum_tpu_torch.shards.fabric", "plenum_tpu_torch.control",
            "plenum_tpu_torch.control.autopilot",
            "plenum_tpu_torch.tools.control_audit",
            "plenum_tpu_torch.tools.bench_configs",
            "plenum_tpu_torch.tools.gpu_probe",
            "plenum_tpu_torch.tools.gpu_microbench",
            "plenum_tpu_torch.tools.multichip"} <= set(mods)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _BLOCKER, *mods], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"imported {len(mods)}" in out.stdout


_FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import plenum_tpu\b(?!_)"
                        r"|from plenum_tpu\b(?!_))|\bplenum_tpu\.", re.M)


@pytest.mark.parametrize("path", sorted(
    [os.path.relpath(os.path.join(d, f), ROOT) for d, _, fs in os.walk(PKG)
     for f in fs if f.endswith(".py")] + ["chip_smoke.py"]))
def test_no_source_mentions_jax_imports_or_the_reference(path):
    with open(os.path.join(ROOT, path)) as fh:
        text = fh.read()
    assert "import jax" not in text
    assert not _FORBIDDEN.search(text), path


@pytest.mark.parametrize("src", ["bn254.cpp", "kvstore.cpp", "mptcodec.cpp"])
def test_native_sources_are_the_ports_own_copies(src, tmp_path, monkeypatch):
    """The host C++ is vendored byte for byte into the port, built from
    there into the port's own 0700 cache under the user's cache home (not
    the checkout, which may be copied to another host), never the
    reference's."""
    from plenum_tpu_torch import native
    ours = os.path.join(PKG, "native", src)
    with open(ours, "rb") as fh, \
            open(os.path.join(ROOT, "plenum_tpu", "native", src), "rb") as ref:
        assert fh.read() == ref.read()
    assert native._DIR == os.path.dirname(ours)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    cache = native._cache_dir()
    assert cache == str(tmp_path / "plenum_tpu_torch" / "native")
    assert os.stat(cache).st_mode & 0o777 == 0o700
    assert not cache.startswith(ROOT + os.sep)
