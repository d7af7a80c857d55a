"""The port's copies of JAX-free reference modules stay the reference's
code: each module below parses, once `plenum_tpu_torch` is read as
`plenum_tpu`, to the same syntax tree as its reference file. Comments and
line wrapping may differ (the rewritten imports rewrap); any change to a
statement, a default or a docstring fails here. The few deliberate
differences are held to exactly what ROADMAP C records."""
import ast
import inspect
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every module of the port that is a copy of the reference, imports
# rewritten and nothing else
COPIES = [
    "catchup/__init__.py", "catchup/cons_proof.py", "catchup/leecher.py",
    "catchup/rep.py", "catchup/seeder.py",
    "client/__init__.py", "client/client.py", "client/pipelined.py",
    "client/sim_clients.py", "client/wallet.py",
    "common/__init__.py", "common/backoff.py", "common/event_bus.py",
    "common/internal_messages.py", "common/message_base.py",
    "common/metrics.py", "common/node_messages.py", "common/quorums.py",
    "common/stashing.py", "common/suspicion_codes.py", "common/timer.py",
    "common/tracing.py",
    "config.py",
    "control/__init__.py", "control/autopilot.py",
    "consensus/__init__.py", "consensus/batch_controller.py",
    "consensus/batch_executor.py", "consensus/batch_id.py",
    "consensus/bls_bft_replica.py", "consensus/checkpoint_service.py",
    "consensus/consensus_shared_data.py", "consensus/ordering_service.py",
    "consensus/primary_health_service.py", "consensus/primary_selector.py",
    "consensus/replica.py", "consensus/view_change_service.py",
    "consensus/view_change_trigger_service.py",
    "crypto/__init__.py", "crypto/bls.py", "crypto/bn254.py",
    "crypto/multi_signature.py",
    "execution/__init__.py", "execution/action_manager.py",
    "execution/database_manager.py", "execution/exceptions.py",
    "execution/executor.py", "execution/read_manager.py",
    "execution/write_manager.py",
    "ingress/__init__.py", "ingress/controller.py", "ingress/plane.py",
    "ingress/observer_reads.py",
    "execution/handlers/__init__.py", "execution/handlers/attrib.py",
    "execution/handlers/audit.py", "execution/handlers/base.py",
    "execution/handlers/freeze.py", "execution/handlers/get_txn.py",
    "execution/handlers/node.py", "execution/handlers/nym.py",
    "execution/handlers/taa.py",
    "ledger/__init__.py", "ledger/hash_store.py", "ledger/merkle_verifier.py",
    "network/__init__.py", "network/sim_network.py", "network/sim_random.py",
    "network/tcp_stack.py",
    "node/__init__.py", "node/blacklister.py", "node/inconsistency_watcher.py",
    "node/looper.py", "node/message_req_processor.py", "node/monitor.py",
    "node/node.py", "node/notifier.py", "node/observer.py",
    "node/observer_node.py", "node/pool_manager.py", "node/propagator.py",
    "node/recorder.py",
    "observability/__init__.py", "observability/aggregator.py",
    "observability/correlate.py", "observability/history.py",
    "observability/snapshot.py",
    "parallel/commit_wave.py", "parallel/crypto_service.py",
    "plugins.py",
    "reads/__init__.py", "reads/client.py", "reads/edge.py",
    "reads/plane.py", "reads/proofs.py",
    "shards/__init__.py", "shards/cross_write.py", "shards/fabric.py",
    "shards/mapping.py", "shards/read_client.py", "shards/reshard.py",
    "shards/router.py",
    "state/__init__.py", "state/native_codec.py", "state/pruning_state.py",
    "state/rlp.py", "state/trie.py",
    "state/commitment/__init__.py", "state/commitment/base.py",
    "state/commitment/kzg.py", "state/commitment/mpt.py",
    "state/commitment/verkle.py",
    "storage/__init__.py", "storage/kv_chunked.py", "storage/kv_file.py",
    "storage/kv_memory.py", "storage/kv_native.py", "storage/kv_store.py",
    "storage/state_ts_store.py",
    "tools/__init__.py", "tools/churn_soak.py", "tools/control_audit.py",
    "tools/fleet_console.py",
    "tools/fuzz_lint.py", "tools/genesis.py", "tools/keygen.py",
    "tools/log_analyzer.py", "tools/metrics_lint.py",
    "tools/metrics_report.py", "tools/micro_costs.py",
    "tools/perf_budget.py", "tools/perf_sentinel.py",
    "tools/proof_vectors.py", "tools/replay.py", "tools/soak.py",
    "tools/start_node.py", "tools/start_observer.py", "tools/tcp_pool.py",
    "tools/trace_report.py",
    "utils/__init__.py", "utils/base58.py",
]


def _source(pkg: str, rel: str) -> str:
    with open(os.path.join(ROOT, pkg, rel)) as fh:
        return fh.read()


def _tree(src: str) -> list[str]:
    return [ast.dump(node) for node in ast.parse(src).body]


def _port_tree(rel: str, src: str = None) -> list[str]:
    src = _source("plenum_tpu_torch", rel) if src is None else src
    return _tree(src.replace("plenum_tpu_torch", "plenum_tpu"))


def _ref_tree(rel: str) -> list[str]:
    return _tree(_source("plenum_tpu", rel))


def _port_lines(rel: str, first: int, last: int) -> str:
    """Lines first..last (1-based) of the port's file."""
    return "".join(
        _source("plenum_tpu_torch", rel).splitlines(True)[first - 1:last])


def _ref_lines(rel: str, first: int, last: int) -> str:
    """Lines first..last (1-based) of the reference's file."""
    return "".join(_source("plenum_tpu", rel).splitlines(True)[first - 1:last])


# deliberate differences inside a copy (ROADMAP C): the port's text, the
# reference's, undone before the comparison
UNDONE = {
    "config.py": [('crypto_backend: str = "cuda"',
                   'crypto_backend: str = "cpu"')],
    # the service's backend names are make_verifier's, its default the
    # card's, supervised as the reference's factory supervises a device;
    # its default socket lies in the temporary directory, not /tmp
    "parallel/crypto_service.py": [
        ("(measured on the reference's TPU)", "(measured, round 4)"),
        ("import struct\nimport tempfile\n", "import struct\n"),
        ('os.path.join(tempfile.gettempdir(), "plenum_crypto.sock")',
         '"/tmp/plenum_crypto.sock"'),
        ('"--backend", default="cuda",', '"--backend", default="cpu",'),
        # the card's first dispatch before the socket exists
        ("import make_verifier, warm_up\n", "import make_verifier\n"),
        ("    warm_up(inner)\n", ""),
        ("supervised=not args.no_supervisor)",
         "supervised=False if args.no_supervisor else None)"),
        ("(cpu | cuda | cuda-sharded via", "(cpu | jax | jax-sharded via"),
        ("[--backend cpu|cuda|cuda-sharded]", "[--backend cpu|jax|jax-sharded]"),
        ('choices=["cpu", "cuda", "cuda-sharded",\n'
         '                             "torch", "torch-sharded"])',
         'choices=["cpu", "jax", "jax-sharded"])')],
    # the module docstring's lines 3-5 drop the reference's change numbers
    "reads/edge.py": [
        ("The verified reads made one VALIDATOR's read reply trustworthy "
         "(the\nproof is anchored to a BLS multi-signed root), and the "
         "observer tier\n(ingress/observer_reads.py) moved serving onto "
         "replicas outside the\n", _ref_lines("reads/edge.py", 3, 5))],
    # the observer's components run on the card unless asked for the CPU
    # (the reference builds them on its "cpu" default)
    "ingress/observer_reads.py": [
        ('    crypto_backend: the components\' backend, the card unless '
         'asked for\n    "cpu" or "torch".\n', ""),
        (',\n                 crypto_backend: str = "cuda"):', "):"),
        ("genesis_txns=genesis, crypto_backend=crypto_backend,",
         "genesis_txns=genesis,"),
        # a fleet's observers run on its fabric's backend
        ("            anchor_lag_max=None,\n"
         "            crypto_backend=self.fabric.config.crypto_backend)",
         "            anchor_lag_max=None)")],
    "node/observer_node.py": [
        ('\ncrypto_backend names the components\' hasher and verifier '
         'backend, the\ncard ("cuda") unless asked for "cpu" or "torch".\n',
         ""),
        (',\n                 crypto_backend: str = "cuda"):', "):"),
        ("storage_backend=storage_backend, crypto_backend=crypto_backend,",
         "storage_backend=storage_backend,")],
    "tools/replay.py": [
        (" \\\n        [--backend cuda|cpu|torch]\n", "\n"),
        ('base_dir: str, backend: str = "cuda") -> dict:',
         "base_dir: str) -> dict:"),
        ("genesis_txns=genesis, crypto_backend=backend,",
         "genesis_txns=genesis,"),
        ('    ap.add_argument("--backend", default="cuda",\n'
         '                    choices=["cuda", "cpu", "torch"])\n', ""),
        ("args.base_dir, args.backend)", "args.base_dir)")],
    "tools/start_observer.py": [
        (" \\\n        [--backend cuda|cpu|torch]\n", "\n"),
        ('    ap.add_argument("--backend", default="cuda",\n'
         '                    choices=["cuda", "cpu", "torch"],\n'
         '                    help="the replicated ledgers\' hasher: the card, "\n'
         '                         "hashlib or the kernels\' plain versions")\n',
         ""),
        (",\n                       crypto_backend=args.backend)", ")")],
    # a node runs on the card unless asked for the CPU, its card verifier
    # supervised as the reference's device nodes are; the backend names
    # are make_verifier's
    "tools/start_node.py": [
        ("        [--backend cuda|service|cpu|torch] [--kv file|memory]\n\n"
         "The default backend, cuda, verifies the node's client signatures "
         "on the\ncard (supervised: a card fault turns into CPU verdicts "
         "that the node's\nmetrics count); service ships them to the "
         "crypto-service process "
         "that owns the\ncard (socket from PLENUM_CRYPTO_SOCKET); cpu and "
         "torch (the kernels'\nplain versions) stay on the host.\n",
         "        [--backend cpu|jax] [--kv file|memory]\n"),
        ('base_dir: str, backend: str = "cuda",',
         'base_dir: str, backend: str = "cpu",'),
        ("    verifier = None\n    if backend == \"cuda\":\n"
         "        from plenum_tpu_torch.crypto.ed25519 import make_verifier, "
         "warm_up\n"
         "        verifier = warm_up(make_verifier(\"cuda\", "
         "supervised=True))\n", ""),
        ("        verifier=verifier,\n", ""),
        ('    ap.add_argument("--backend", default="cuda",\n'
         '                    choices=["cpu", "cuda", "service", "torch"])',
         '    ap.add_argument("--backend", default="cpu",\n'
         '                    choices=["cpu", "jax", "service"])')],
    # the tcpsvc topology on the card by default; CUDA_VISIBLE_DEVICES=""
    # hides the card from every process but its owners, as the
    # reference's JAX_PLATFORMS=cpu; the single-device verifier does not
    # pad, so the service's min_batch is one default
    "tools/tcp_pool.py": [
        ("        [--backend service:cuda|service:cuda-sharded|service:cpu|"
         "cuda|cpu]\n\nThe default, service:cuda, is the tcpsvc topology "
         "on the card: one\ncrypto-service process owns the GPU and "
         "verifies every node's client\nsignatures; the node processes "
         "see no GPU.\n", ""),
        ('n_txns: int = 200,\n                 backend: str = "service:cuda",',
         'n_txns: int = 200, backend: str = "cpu",'),
        ("env = dict(os.environ, PYTHONPATH=REPO)\n",
         'env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")\n'),
        ('service_env = env if inner.startswith("cuda") else \\\n'
         '                dict(env, CUDA_VISIBLE_DEVICES="")',
         'service_env = dict(env)\n'
         '            if inner.startswith("jax"):\n'
         '                service_env.pop("JAX_PLATFORMS", None)'),
        ("                                    else 128)],",
         '                                    else (512 if inner.startswith('
         '"jax")\n                                          else 128))],'),
        ('        node_env = env if backend == "cuda" else \\\n'
         '            dict(env, CUDA_VISIBLE_DEVICES="")\n', ""),
        ("cmd, env=node_env, cwd=REPO,", "cmd, env=env, cwd=REPO,"),
        ('    ap.add_argument("--backend", default="service:cuda",\n'
         '                    choices=["cpu", "cuda", "torch", "service:cpu",\n'
         '                             "service:cuda", "service:cuda-sharded",\n'
         '                             "service:torch"])',
         '    ap.add_argument("--backend", default="cpu",\n'
         '                    choices=["cpu", "jax", "service:cpu", '
         '"service:jax",\n                             "service:jax-sharded"])')],
    # the port's CryptoPipeline takes its Ed25519 inner explicitly; the
    # reference's default inner is this CPU verifier
    "tools/proof_vectors.py": [
        ("    from plenum_tpu_torch.crypto.ed25519 import CpuEd25519Verifier\n",
         ""),
        ("CryptoPipeline(CpuEd25519Verifier())", "CryptoPipeline()")],
    # the docstring's history notes name no change number (lines 5, 18)
    "tools/perf_sentinel.py": [
        (_port_lines("tools/perf_sentinel.py", 5, 5),
         _ref_lines("tools/perf_sentinel.py", 5, 5)),
        (_port_lines("tools/perf_sentinel.py", 18, 18),
         _ref_lines("tools/perf_sentinel.py", 18, 18))],
    # the pool's crypto backend is a parameter, the card unless asked for
    # the CPU (the reference's soak runs a "cpu" pool)
    "tools/soak.py": [
        (" \\\n        [--backend cuda|cpu|torch]\n", "\n"),
        ("n_nodes: int = 4, backend: str = \"cuda\") -> dict:",
         "n_nodes: int = 4) -> dict:"),
        ("build_pool(n_nodes, backend)", "build_pool(n_nodes, \"cpu\")"),
        ('    ap.add_argument("--backend", default="cuda",\n'
         '                    choices=["cpu", "cuda", "torch"])\n', ""),
        ("run_soak(args.seconds, args.wave,\n"
         "                              backend=args.backend)",
         "run_soak(args.seconds, args.wave)")],
    # the lint reads the port's suite
    "tools/fuzz_lint.py": [
        ("tests/test_torch_sim_fuzz.py by AST", "tests/test_sim_fuzz.py by AST"),
        ('"tests", "test_torch_sim_fuzz.py")', '"tests", "test_sim_fuzz.py")')],
    # the soak's pool takes the port's test helpers and a crypto backend,
    # the card unless asked for the CPU (the reference's Config says cpu)
    "tools/churn_soak.py": [
        (" [--backend cpu] [--json]", " [--json]"),
        ("(tests/test_torch_resilience.py)", "(tests/test_resilience.py)"),
        (",\n                   crypto_backend: str = \"cuda\") -> dict:",
         ") -> dict:"),
        (" `crypto_backend` is the nodes'\n    (the card unless asked for "
         "\"cpu\" or \"torch\").", ""),
        ("from test_torch_pool import Pool, signed_nym            # noqa",
         "from test_pool import Pool, signed_nym                  # noqa"),
        ("from test_torch_scale import signed_node_services       # noqa",
         "from test_scale import signed_node_services             # noqa"),
        ("Config(Max3PCBatchWait=0.05, crypto_backend=crypto_backend,",
         "Config(Max3PCBatchWait=0.05,"),
        ('    ap.add_argument("--backend", default="cuda",\n'
         '                    choices=["cpu", "cuda", "torch"])\n', ""),
        ("leak_rate=args.leak_rate,\n                         "
         "crypto_backend=args.backend)", "leak_rate=args.leak_rate)")],
}


def _undone(rel: str) -> str:
    src = _source("plenum_tpu_torch", rel)
    for port_text, ref_text in UNDONE.get(rel, ()):
        assert src.count(port_text) == 1, port_text
        src = src.replace(port_text, ref_text)
    return src


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_the_reference_code(rel):
    assert _port_tree(rel, _undone(rel)) == _ref_tree(rel)


def test_crypto_service_takes_the_ports_backend_names(monkeypatch):
    """The service's --backend choices are make_verifier's names, not the
    reference's JAX ones; its default is the card, supervised unless
    --no-supervisor, and its socket lies in the temporary directory;
    test_copy_is_the_reference_code holds the rest."""
    import tempfile

    from plenum_tpu_torch.crypto import ed25519
    from plenum_tpu_torch.parallel import crypto_service
    with pytest.raises(SystemExit):
        crypto_service.main(["--backend", "jax"])
    assert crypto_service.DEFAULT_SOCKET == os.path.join(
        tempfile.gettempdir(), "plenum_crypto.sock")

    class Built(Exception):
        pass

    asked = []

    def make_verifier(backend, **kw):
        asked.append((backend, kw))
        raise Built

    monkeypatch.setattr(ed25519, "make_verifier", make_verifier)
    for argv in ([], ["--no-supervisor"], ["--backend", "torch"]):
        with pytest.raises(Built):
            crypto_service.main(argv)
    assert asked == [("cuda", {"min_batch": 128, "supervised": True}),
                     ("cuda", {"min_batch": 128, "supervised": False}),
                     ("torch", {"min_batch": 128, "supervised": True})]
    from plenum_tpu_torch.crypto.bls import BlsCryptoVerifier
    for backend in ("cpu", "cuda", "cuda-sharded", "torch", "torch-sharded"):
        assert isinstance(crypto_service.make_bls_verifier(backend),
                          BlsCryptoVerifier)


def test_config_differs_only_in_its_card_default():
    """Config's crypto_backend names the card, as NodeBootstrap's does:
    the reference's Node, start_node and shard fabric read it, so the
    port's would run on the card unless asked for the CPU. The reference
    says "cpu"; test_copy_is_the_reference_code holds the rest."""
    from plenum_tpu.config import Config as RefConfig
    from plenum_tpu_torch.config import Config
    assert Config().crypto_backend == "cuda"
    assert RefConfig().crypto_backend == "cpu"


def test_bootstrap_differs_only_in_its_card_default():
    """NodeBootstrap runs on the card unless asked for the CPU; the
    reference defaults to "cpu". Nothing else differs."""
    from plenum_tpu_torch.node.bootstrap import NodeBootstrap
    default = inspect.signature(NodeBootstrap).parameters["crypto_backend"]
    assert default.default == "cuda"
    src = _source("plenum_tpu_torch", "node/bootstrap.py")
    line = 'crypto_backend: str = "cuda",'
    assert src.count(line) == 1
    assert _port_tree("node/bootstrap.py",
                      src.replace(line, 'crypto_backend: str = "cpu",')) == \
        _ref_tree("node/bootstrap.py")


def test_native_loader_differs_only_in_its_cache_dir():
    """The port builds into its own cache (tests/test_torch_isolation.py
    holds where); every other statement is the reference's."""
    def without_cache_dir(tree: list[str]) -> list[str]:
        kept = [d for d in tree if "name='_cache_dir'" not in d[:60]]
        assert len(kept) == len(tree) - 1
        return kept
    assert without_cache_dir(_port_tree("native/__init__.py")) == \
        without_cache_dir(_ref_tree("native/__init__.py"))


def test_local_pool_holds_the_reference_genesis_builders():
    """tools/local_pool.py is the reference's with the device arm ported
    (ROADMAP C): pool_bls_keys, build_genesis and commit_stage_stats are
    the reference's code whole; build_pool's "jax" arm is "cuda" (and
    "torch" on the CPU) on make_crypto_pipeline's single-device ring, its
    "jax-percall" arm "cuda-percall" with a supervised verifier per node;
    run_load and main default to "cuda"."""
    port = ast.parse(_source("plenum_tpu_torch", "tools/local_pool.py")
                     .replace("plenum_tpu_torch", "plenum_tpu")).body
    ref = ast.parse(_source("plenum_tpu", "tools/local_pool.py")).body
    defs = {n.name: n for n in port if isinstance(n, ast.FunctionDef)}
    ref_defs = {n.name: n for n in ref if isinstance(n, ast.FunctionDef)}
    assert list(defs) == list(ref_defs) == [
        "pool_bls_keys", "build_genesis", "build_pool", "commit_stage_stats",
        "run_load", "main"]
    for name in ("pool_bls_keys", "build_genesis", "commit_stage_stats"):
        assert ast.dump(defs[name]) == ast.dump(ref_defs[name]), name
    # run_load: the default backend, the percall arm's name, and the
    # on_pin hook (called with the ring after its pin())
    run_load = defs["run_load"]
    assert [a.arg for a in run_load.args.args][-1] == "on_pin"
    run_load.args.args.pop()
    run_load.args.defaults.pop()
    src = ast.unparse(run_load).replace(
        "backend: str='cuda'", "backend: str='cpu'").replace(
        "'cuda-percall'", "'jax-percall'").replace(
        "\n        if on_pin is not None:\n            on_pin(pipe)", "")
    doc = src.index("measurement).") + len("measurement).")
    src = src[:doc] + src[src.index('"""', doc):]
    assert src == ast.unparse(ref_defs["run_load"])
    main_src = ast.unparse(defs["main"]).replace(
        "default='cuda', choices=['cpu', 'cuda', 'cuda-percall', 'torch']",
        "default='cpu', choices=['cpu', 'jax', 'jax-percall']")
    assert main_src == ast.unparse(ref_defs["main"])
    assert [ast.dump(n) for n in port[1:]
            if not isinstance(n, ast.FunctionDef)] == \
        [ast.dump(n) for n in ref[1:] if not isinstance(n, ast.FunctionDef)]


def _defs(pkg: str, rel: str, src: str = None) -> dict:
    src = _source(pkg, rel) if src is None else src
    return {n.name: ast.dump(n) for n in ast.parse(
        src.replace("plenum_tpu_torch", "plenum_tpu")).body
        if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


def test_federation_differs_only_in_its_lanes_devices():
    """parallel/federation.py is the reference's but for
    make_federated_pipeline, whose local lanes are pipeline.lane_inners'
    torch verifiers on `devices` (the reference's are jax verifiers), and
    its docstring's opening, which names no change number."""
    rel = "parallel/federation.py"
    src = _source("plenum_tpu_torch", rel).replace(
        _port_lines(rel, 4, 4), _ref_lines(rel, 4, 4))
    port, ref = _defs("plenum_tpu_torch", rel, src), _defs("plenum_tpu", rel)
    assert list(port) == list(ref)
    for name in port:
        if name != "make_federated_pipeline":
            assert port[name] == ref[name], name
    assert [ast.dump(n) for n in ast.parse(src.replace(
        "plenum_tpu_torch", "plenum_tpu")).body
        if not isinstance(n, (ast.FunctionDef, ast.ClassDef))] == \
        [ast.dump(n) for n in ast.parse(_source("plenum_tpu", rel)).body
         if not isinstance(n, (ast.FunctionDef, ast.ClassDef))]


def test_multidevice_ring_and_crypto_host_roster_are_the_references():
    """MultiDeviceCryptoPipeline is the reference's class statement for
    statement (its docstring's first line names no change number; the
    lane rule lives in _DeviceLane, ROADMAP C), and
    multihost.crypto_host_roster is the reference's function."""
    rel = "parallel/pipeline.py"

    def first_line(pkg):
        return next(line for line in _source(pkg, rel).splitlines(True)
                    if "submission ring sharded across N chips" in line)
    port = _source("plenum_tpu_torch", rel).replace(
        first_line("plenum_tpu_torch"), first_line("plenum_tpu"))
    assert _defs("plenum_tpu_torch", rel, port)["MultiDeviceCryptoPipeline"] \
        == _defs("plenum_tpu", rel)["MultiDeviceCryptoPipeline"]
    assert _defs("plenum_tpu_torch", "parallel/multihost.py")[
        "crypto_host_roster"] == _defs("plenum_tpu", "parallel/multihost.py")[
        "crypto_host_roster"]


class _CpuArms(ast.NodeTransformer):
    """Undo bench_configs' backend parameter: the `backend` argument goes,
    its uses read the reference's "cpu", and the keywords that only pass
    it along (crypto_backend=..., and backend=... to the module's own
    helpers) go."""
    HELPERS = {"_sim25_once", "_sharded_arm_once", "_telemetry_hot_shard_arm"}

    def visit_FunctionDef(self, node):
        self.generic_visit(node)
        args = node.args
        names = [a.arg for a in args.args]
        if "backend" in names:
            i = names.index("backend")
            assert i == len(names) - 1
            args.args.pop()
            args.defaults.pop()
        return node

    def visit_Name(self, node):
        if node.id == "backend":
            return ast.copy_location(ast.Constant("cpu"), node)
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        callee = getattr(node.func, "id", getattr(node.func, "attr", ""))
        node.keywords = [
            k for k in node.keywords
            if not (k.arg == "crypto_backend"
                    or (k.arg == "backend" and callee in self.HELPERS))]
        return node


# bench_configs' device A/Bs run the port's lanes in their subprocess
# (no jax.config, no XLA flags), config4's nodes take --backend, and the
# three helpers below are the port's own (ROADMAP C)
BENCH_REWRITTEN = {
    "config4_viewchange_under_load", "_pipeline_ab_inproc",
    "config8_pipeline_ab", "_multichip_ab_inproc", "config14_multichip",
    "_federation_ab_inproc", "config17_federation",
    "_ordered_path_ab_inproc", "config16_ordered_path", "config19_edge"}
BENCH_HELPERS = ["_torch_source", "_child_env", "_lanes_on"]


def test_bench_configs_differ_only_in_backend_and_lanes():
    """tools/bench_configs.py is the reference's with a `backend`
    parameter (default "cuda") on every config that builds a pool: with
    it undone (the reference's "cpu" in its place) each such function is
    the reference's, statement for statement. The device A/Bs, config4
    and config19 (its provenance key) are rewritten for the port's lanes
    and named here; every one of them takes `backend`, default "cuda"."""
    rel = "tools/bench_configs.py"
    src = _source("plenum_tpu_torch", rel).replace(
        "plenum_tpu_torch", "plenum_tpu").replace(
        "the SAME 4-node write load with the",
        "the SAME 4-node cpu write load with the")
    port = ast.parse(src)
    ref = ast.parse(_source("plenum_tpu", rel))
    port_defs = {n.name: n for n in port.body
                 if isinstance(n, ast.FunctionDef)}
    ref_defs = {n.name: n for n in ref.body if isinstance(n, ast.FunctionDef)}
    assert [n for n in port_defs if n not in BENCH_HELPERS] == list(ref_defs)
    assert BENCH_REWRITTEN <= set(ref_defs)
    for name, node in port_defs.items():
        if name in BENCH_HELPERS:
            continue
        params = {a.arg: d for a, d in zip(
            node.args.args[-len(node.args.defaults):], node.args.defaults)} \
            if node.args.defaults else {}
        if name in ("_mixed_requests", "_drive_inprocess",
                    "_host_calib_ms", "main"):
            assert "backend" not in params, name
        else:
            assert ast.literal_eval(params["backend"]) == "cuda", name
        if name in BENCH_REWRITTEN:
            continue
        ours = ast.dump(_CpuArms().visit(node))
        if name == "config13_commitment":
            # its arms are the commitment schemes (the reference calls
            # them `backend`)
            ours = ours.replace("'scheme'", "'backend'")
        assert ours == ast.dump(ref_defs[name]), name
    assert [ast.dump(n) for n in port.body[1:]
            if not isinstance(n, ast.FunctionDef)] == \
        [ast.dump(n) for n in ref.body[1:]
         if not isinstance(n, ast.FunctionDef)]
