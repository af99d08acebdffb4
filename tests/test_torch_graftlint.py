"""The port's graftlint (``marl_distributedformation_tpu_torch/analysis``):
every rule fires on a known-bad fixture in the shape of a ``PhaseGraph``
capture and stays quiet on its known-good twin; the graftlock engine
reports what the JAX package's reports on JAX's own lock fixtures; every
JAX rule is a port rule or has a stated reason in ``NO_COUNTERPART``; the
CLI's exit codes; and the port's package itself is clean, linted once.

A hazard in a captured body (a ``.item()``, a ``print``, a tracer span)
runs at the warm-up and the capture and never on a replay; on the CPU the
body runs eagerly every call, so this linter is the one tier-1 guard."""

import ast
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from marl_distributedformation_tpu.analysis import callgraph as jax_callgraph
from marl_distributedformation_tpu.analysis import (
    lint_source as jax_lint_source,
)
from marl_distributedformation_tpu.analysis.rules import (
    rule_names as jax_rule_names,
)
from marl_distributedformation_tpu_torch.analysis import (
    GraftlintConfig,
    Violation,
    lint_paths,
    lint_source,
    load_config,
)
from marl_distributedformation_tpu_torch.analysis import callgraph
from marl_distributedformation_tpu_torch.analysis.config import (
    config_from_dict,
)
from marl_distributedformation_tpu_torch.analysis.rules import (
    NO_COUNTERPART,
    RULES,
    rule_names,
)

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "marl_distributedformation_tpu_torch"
GRAFTLOCK = ("lock-ordering-cycle", "unguarded-shared-mutation",
             "blocking-call-under-dispatch-lock",
             "lock-released-across-await-seam")


def lint(src, tmp_path=None):
    """Lint a fixture: a string is one in-memory module; a dict
    ``{filename: source}`` is written to ``tmp_path`` (the call graph
    resolves imports on disk) and every file of it is linted."""
    if isinstance(src, dict):
        for name, content in src.items():
            (tmp_path / name).write_text(textwrap.dedent(content))
        return lint_paths([tmp_path])
    return lint_source(textwrap.dedent(src), "fixture.py")


def fired(src, tmp_path=None):
    return {v.rule for v in lint(src, tmp_path)}


HEAD = """
import numpy as np
import torch

from marl_distributedformation_tpu_torch.train.capture import PhaseGraph
"""

# (rule, known-bad, known-good): each bad fixture puts the hazard in a
# body a PhaseGraph captures (or, for the host-loop rules, in the host loop
# around one); its good twin keeps the body on the device.
FIXTURES = [
    ("numpy-in-jit", HEAD + """
class Phase:
    def __init__(self, stream):
        self.buf = torch.zeros(4)
        self.graph = PhaseGraph("p", self._fn, stream=stream)

    def _fn(self):
        self.out = np.sum(self.buf)
""", HEAD + """
class Phase:
    def __init__(self, stream):
        self.buf = torch.zeros(4)
        self.graph = PhaseGraph("p", self._fn, stream=stream)

    def _fn(self):
        table = np.arange(4)  # a host constant of the graph
        self.out = self.buf.sum() + float(table[0])
"""),
    ("traced-python-control-flow", HEAD + """
def build(stream):
    loss = torch.zeros(())
    def fn():
        if loss > 0:
            loss.zero_()
    return PhaseGraph("p", fn, stream=stream)
""", HEAD + """
def build(stream, clip=True):
    loss = torch.zeros(())
    def fn():
        if clip and loss.shape == ():
            loss.copy_(torch.where(loss > 0, torch.zeros(()), loss))
    return PhaseGraph("p", fn, stream=stream)
"""),
    ("prng-key-reuse", HEAD + """
def build(stream, device):
    act_gen = torch.Generator(device)
    noise_gen = torch.Generator(device)
    out = torch.zeros(4, device=device)
    def fn():
        out.copy_(torch.randn(4, generator=noise_gen, device=device))
    return PhaseGraph("p", fn, (act_gen,), stream=stream)
""", HEAD + """
def build(stream, device):
    act_gen = torch.Generator(device)
    noise_gen = torch.Generator(device)
    out = torch.zeros(4, device=device)
    def fn():
        out.copy_(torch.randn(4, generator=noise_gen, device=device))
    return PhaseGraph("p", fn, (act_gen, noise_gen), stream=stream)
"""),
    ("host-sync-in-jit", HEAD + """
def build(x, stream):
    def fn():
        total = x.sum().item()
        x.add_(total)
    return PhaseGraph("p", fn, stream=stream)
""", HEAD + """
def build(x, stream):
    def fn():
        x.add_(x.sum())
    graph = PhaseGraph("p", fn, stream=stream)
    graph()
    return x.sum().item()  # the drain, outside the capture
"""),
    ("mutable-capture-in-jit", HEAD + """
CALLS = 0

def fn():
    global CALLS
    CALLS += 1

GRAPH = PhaseGraph("p", fn, stream=None)
""", HEAD + """
CALLS = torch.zeros((), dtype=torch.int64)

def fn():
    CALLS.add_(1)

GRAPH = PhaseGraph("p", fn, stream=None)
"""),
    ("print-in-jit", HEAD + """
def build(x, stream):
    def fn():
        x.mul_(2)
        print("stepped", x.shape)
    return PhaseGraph("p", fn, stream=stream)
""", HEAD + """
def build(x, stream):
    def fn():
        if x.dim() != 1:
            raise ValueError(f"a vector, not {x.shape}")
        x.mul_(2)
    print("built", x.shape)
    return PhaseGraph("p", fn, stream=stream)
"""),
    ("implicit-f64-promotion", HEAD + """
def build(x, stream):
    def fn():
        x.add_(torch.ones(4, dtype=torch.float64))
    return PhaseGraph("p", fn, stream=stream)
""", HEAD + """
def build(x, stream):
    def fn():
        x.add_(torch.ones(4, dtype=torch.float32))
    return PhaseGraph("p", fn, stream=stream)
"""),
    ("span-in-traced-scope", HEAD + """
from marl_distributedformation_tpu_torch.obs import get_tracer

def build(x, stream):
    def fn():
        with get_tracer().span("rollout"):
            x.mul_(2)
    return PhaseGraph("p", fn, stream=stream)
""", HEAD + """
from marl_distributedformation_tpu_torch.obs import get_tracer

def run(x, stream):
    def fn():
        x.mul_(2)
    graph = PhaseGraph("p", fn, stream=stream)
    with get_tracer().span("rollout"):
        graph()
"""),
    ("device-put-in-dispatch-loop", HEAD + """
def serve(engine, queue, device):
    while True:
        rows = queue.get()
        engine.x.copy_(rows.to(device))
        engine.graph()
""", HEAD + """
def serve(engine, queue, device):
    staging = torch.zeros_like(engine.x).to(device)
    while True:
        rows = queue.get()
        staging.copy_(rows, non_blocking=True)
        engine.graph()
"""),
    ("traced-python-comparison-in-search", HEAD + """
def pick(cand, best):
    if cand.max() > best.max():
        return cand
    return best

def build(pop, best, stream):
    def fn():
        for cand in pop:
            best.copy_(pick(cand, best))
    return PhaseGraph("p", fn, stream=stream)
""", HEAD + """
def pick(cand, best):
    return torch.where(cand.max() > best.max(), cand, best)

def build(pop, best, stream):
    def fn():
        for cand in pop:
            best.copy_(pick(cand, best))
    return PhaseGraph("p", fn, stream=stream)
"""),
    ("metrics-in-traced-scope", HEAD + """
from marl_distributedformation_tpu_torch.obs import get_registry

def build(x, stream):
    def fn():
        x.mul_(2)
        get_registry().counter("steps_total").inc()
    return PhaseGraph("p", fn, stream=stream)
""", HEAD + """
from marl_distributedformation_tpu_torch.obs import get_registry

def run(x, stream):
    def fn():
        x.mul_(2)
    graph = PhaseGraph("p", fn, stream=stream)
    graph()
    get_registry().counter("steps_total").inc()
"""),
    ("fault-point-in-traced-scope", HEAD + """
from marl_distributedformation_tpu_torch.chaos import fault_point

def build(x, stream):
    def fn():
        fault_point("train.rollout")
        x.mul_(2)
    return PhaseGraph("p", fn, stream=stream)
""", HEAD + """
from marl_distributedformation_tpu_torch.chaos import fault_point

def run(x, stream):
    def fn():
        x.mul_(2)
    graph = PhaseGraph("p", fn, stream=stream)
    fault_point("train.rollout")
    graph()
"""),
    ("ledger-record-in-traced-scope", HEAD + """
from marl_distributedformation_tpu_torch.obs import get_ledger

def build(x, stream):
    def fn():
        x.mul_(2)
        get_ledger().dispatch("trainer/rollout", 0.0)
    return PhaseGraph("p", fn, stream=stream)
""", HEAD + """
import time

from marl_distributedformation_tpu_torch.obs import get_ledger

def run(x, stream):
    def fn():
        x.mul_(2)
    graph = PhaseGraph("p", fn, stream=stream)
    t0 = time.perf_counter()
    graph()
    get_ledger().dispatch("trainer/rollout", time.perf_counter() - t0)
"""),
    ("rpc-in-traced-scope", HEAD + """
from urllib.request import urlopen

def build(x, url, stream):
    def fn():
        urlopen(url)
        x.mul_(2)
    return PhaseGraph("p", fn, stream=stream)
""", HEAD + """
from urllib.request import urlopen

def run(x, url, stream):
    def fn():
        x.mul_(2)
    graph = PhaseGraph("p", fn, stream=stream)
    graph()
    urlopen(url)
"""),
    ("host-nonfinite-probe-in-dispatch-loop", HEAD + """
def train(phases, loss, iterations):
    for _ in range(iterations):
        for phase in phases:
            phase()
        if torch.isnan(loss).any():
            break
""", HEAD + """
def train(phases, loss, health, iterations):
    for _ in range(iterations):
        for phase in phases:
            phase()  # the graph folds isnan(loss) into the health word
    return bool(torch.isfinite(loss).all())  # once, after the loop
"""),
    ("blocking-transfer-in-actor-loop", HEAD + """
class Actor:
    def actor_loop(self, queue, stop):
        while not stop.is_set():
            self.phase()
            torch.cuda.synchronize()
            queue.put(self.batch)
""", HEAD + """
class Actor:
    def actor_loop(self, queue, stop):
        while not stop.is_set():
            self.phase()
            self.done.record()
            queue.put(self.batch, self.done)
"""),
    ("env-contract-impurity", HEAD + """
import random

def step_batch(state, action, generator):
    wind = random.random()
    return state + action * wind
""", HEAD + """
def step_batch(state, action, generator):
    wind = torch.rand((), generator=generator, device=state.device)
    return state + action * wind
"""),
    ("lock-ordering-cycle", HEAD + """
import threading

_STREAMS_LOCK = threading.Lock()
_CAPTURE_LOCK = threading.Lock()

def own_stream():
    with _STREAMS_LOCK:
        with _CAPTURE_LOCK:
            pass

def capture():
    with _CAPTURE_LOCK:
        with _STREAMS_LOCK:
            pass
""", HEAD + """
import threading

_STREAMS_LOCK = threading.Lock()
_CAPTURE_LOCK = threading.Lock()

def own_stream():
    with _STREAMS_LOCK:
        with _CAPTURE_LOCK:
            pass

def capture():
    with _STREAMS_LOCK:
        with _CAPTURE_LOCK:
            pass
"""),
    ("unguarded-shared-mutation", HEAD + """
import threading

class Engine:
    def __init__(self):
        self._lock = threading.Lock()
        self.swaps = 0  # graftlock: guarded-by=_lock

    def start(self):
        threading.Thread(target=self._worker).start()

    def _worker(self):
        self.swaps = self.swaps + 1
""", HEAD + """
import threading

class Engine:
    def __init__(self):
        self._lock = threading.Lock()
        self.swaps = 0  # graftlock: guarded-by=_lock

    def start(self):
        threading.Thread(target=self._worker).start()

    def _worker(self):
        with self._lock:
            self.swaps = self.swaps + 1
"""),
    ("blocking-call-under-dispatch-lock", HEAD + """
import threading

class Replica:
    def __init__(self):
        self.batch_lock = threading.Lock()

    def swap(self, params):
        with self.batch_lock:
            self.params.copy_(params)
            torch.cuda.synchronize()
""", HEAD + """
import threading

class Replica:
    def __init__(self):
        self.batch_lock = threading.Lock()

    def swap(self, params):
        with self.batch_lock:
            self.params.copy_(params)
        torch.cuda.synchronize()
"""),
    ("lock-released-across-await-seam", HEAD + """
import threading

class Engine:
    def __init__(self, pool):
        self._act_lock = threading.Lock()
        self._pool = pool

    def kick(self):
        with self._act_lock:
            self._pool.submit(self._act)

    def _act(self):
        with self._act_lock:
            self.graph()
""", HEAD + """
import threading

class Engine:
    def __init__(self, pool):
        self._act_lock = threading.Lock()
        self._pool = pool

    def kick(self):
        with self._act_lock:
            pending = self.graph
        self._pool.submit(self._act)

    def _act(self):
        with self._act_lock:
            self.graph()
"""),
]
IDS = [f[0] for f in FIXTURES]


def test_every_rule_has_a_fixture():
    assert sorted(IDS) == sorted(rule_names())


@pytest.mark.parametrize("rule, bad, good", FIXTURES, ids=IDS)
def test_rule_fires_on_bad_fixture(rule, bad, good):
    assert rule in fired(bad), lint(bad)


@pytest.mark.parametrize("rule, bad, good", FIXTURES, ids=IDS)
def test_rule_quiet_on_good_fixture(rule, bad, good):
    assert fired(good) == set(), lint(good)


# ---------------------------------------------------------------------------
# What is captured
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", ["method", "closure", "lambda", "fn_kw",
                                   "phase_fns", "subclass", "loop_literal"])
def test_captured_scopes(shape):
    """Each way a body reaches a PhaseGraph is captured; a same-named
    method next to the closure is not."""
    src = {
        "method": """
            class Rung:
                def __init__(self, stream):
                    self.graph = PhaseGraph("act", self._act, stream=stream)
                def _act(self):
                    self.out = self.x.cpu()
            """,
        "closure": """
            class Rung:
                def __init__(self, engine, stream):
                    def act():
                        self.out = engine.x.cpu()
                    self.graph = PhaseGraph("act", act, stream=stream)
                def act(self):
                    return self.out.cpu()  # the public, uncaptured act
            """,
        "lambda": """
            def build(x, stream):
                return PhaseGraph("p", lambda: x.cpu(), stream=stream)
            """,
        "fn_kw": """
            def body(x):
                return x.cpu()
            def build(stream):
                return PhaseGraph("p", fn=body, stream=stream)
            """,
        "phase_fns": """
            class Iteration:
                def phase_fns(self):
                    return [("rollout", self.rollout), ("end", self.end)]
                def rollout(self):
                    self.out = self.x.cpu()
                def end(self):
                    pass
            """,
        "subclass": """
            class Iteration:
                def phase_fns(self):
                    return [("rollout", self.rollout)]
                def rollout(self):
                    pass
            class Sharded(Iteration):
                def rollout(self):
                    self.out = self.x.cpu()
            """,
        "loop_literal": """
            class Lane:
                def __init__(self, learner, stream):
                    def minibatch():
                        learner.x.cpu()
                    self.phases = [PhaseGraph(n, fn, stream=stream)
                                   for n, fn in (("mb", minibatch),)]
            """,
    }[shape]
    found = lint(src)
    assert [v.rule for v in found] == ["host-sync-in-jit"], found
    if shape == "closure":
        assert found[0].line == 5


def test_a_captured_scope_reaches_across_modules(tmp_path):
    """A helper in another module, called from a captured body, is
    captured too: its ``.item()`` and its tracer span are reported in its
    own file."""
    found = lint({
        "__init__.py": "",
        "helpers.py": """
            from obs import get_tracer

            def advance(x):
                with get_tracer().span("advance"):
                    return x.sum().item()

            def host_only(x):
                return x.sum().item()  # called from no capture
            """,
        "main.py": """
            from helpers import advance, host_only

            def build(x, stream):
                def fn():
                    x.add_(advance(x))
                host_only(x)
                return PhaseGraph("p", fn, stream=stream)
            """,
    }, tmp_path)
    assert {(Path(v.path).name, v.rule, v.line) for v in found} == {
        ("helpers.py", "span-in-traced-scope", 5),
        ("helpers.py", "host-sync-in-jit", 6),
    }


def test_taint_reads_tensors_not_config():
    """Tensors are the params, the closed-over torch values and the
    instance's torch attributes; a config flag, a shape, a device and an
    annotated host param are not."""
    found = lint("""
        class Phase:
            def __init__(self, model, stream):
                self.t = torch.zeros(())
                self.flag = bool(model.per_formation)
                self.graph = PhaseGraph("p", self._fn, stream=stream)

            def _fn(self):
                if self.flag and self.t.device.type == "cuda":
                    pass
                if self.t.shape[0] > 1 and self.t.numel() > 2:
                    pass
                if self.t > 0:
                    pass
                self.helper(self.t, (4,))

            def helper(self, x, shape: tuple):
                if shape[0] > 2:
                    pass
        """)
    assert [(v.rule, v.line) for v in found] == [
        ("traced-python-control-flow", 13)]


# ---------------------------------------------------------------------------
# graftlock against the JAX package's engine
# ---------------------------------------------------------------------------


def _jax_callgraph_fixtures():
    """The module sources JAX's tests/test_callgraph.py analyzes alone
    (the arguments of its ``graph(...)`` calls, and ``_STORE``)."""
    tree = ast.parse((REPO / "tests" / "test_callgraph.py").read_text())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "graph" and node.args
                and isinstance(node.args[0], ast.Constant)):
            out[f"line{node.lineno}"] = node.args[0].value
        elif (isinstance(node, ast.Assign)
              and isinstance(node.value, ast.Constant)
              and isinstance(node.value.value, str)
              and "import threading" in node.value.value):
            out[node.targets[0].id] = node.value.value
    return out


CALLGRAPH_FIXTURES = _jax_callgraph_fixtures()


def _graph(module, src):
    source = textwrap.dedent(src)
    mod = module.ModuleInfo("mem.py", ast.parse(source), source)
    return module.PackageGraph({"mem.py": mod}, module.CallGraphEngine())


@pytest.mark.parametrize("name", sorted(CALLGRAPH_FIXTURES))
def test_callgraph_fixtures_match_jax(name):
    src = CALLGRAPH_FIXTURES[name]
    jax_pg, port_pg = _graph(jax_callgraph, src), _graph(callgraph, src)
    assert port_pg.findings == jax_pg.findings
    assert {k: (s.qualname, s.line, s.chain, s.acquired)
            for k, s in port_pg.lock_edges.items()} == {
        k: (s.qualname, s.line, s.chain, s.acquired)
        for k, s in jax_pg.lock_edges.items()}
    jax_threads = {f.qualname for f in jax_pg._thread_entries()}
    assert {f.qualname for f in port_pg._thread_entries()} == jax_threads


def _jax_graftlock_fixtures():
    """JAX's tests/test_graftlint.py one-module fixture pairs of the four
    graftlock rules, read from its syntax tree."""
    tree = ast.parse((REPO / "tests" / "test_graftlint.py").read_text())
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "FIXTURES"):
            for entry in node.value.elts:
                rule, bad, good = ast.literal_eval(entry)
                if rule in GRAFTLOCK and isinstance(bad, str):
                    out.append((rule, bad, good))
    return out


# JAX's drain blocks in jax.device_get; the port's in torch.cuda.synchronize.
_DRAIN = ("jax.device_get(", "torch.cuda.synchronize(")


@pytest.mark.parametrize("which", ["bad", "good"])
@pytest.mark.parametrize(
    "rule, bad, good", _jax_graftlock_fixtures(),
    ids=[f"{f[0]}-{i}" for i, f in enumerate(_jax_graftlock_fixtures())])
def test_graftlock_fixtures_match_jax(rule, bad, good, which):
    src = textwrap.dedent(bad if which == "bad" else good)
    want = [(v.rule, v.line, v.col, v.message.replace(*_DRAIN))
            for v in jax_lint_source(src, "fixture.py")
            if v.rule in GRAFTLOCK]
    port_src = src.replace("import jax\n", "import torch\n").replace(
        *_DRAIN)
    got = [(v.rule, v.line, v.col, v.message)
           for v in lint_source(port_src, "fixture.py")
           if v.rule in GRAFTLOCK]
    assert got == want
    assert (rule in {g[0] for g in got}) == (which == "bad")


# ---------------------------------------------------------------------------
# The registry, suppression, config
# ---------------------------------------------------------------------------


def test_every_jax_rule_is_ported_or_has_no_counterpart():
    port, jax = set(rule_names()), set(jax_rule_names())
    assert not port & set(NO_COUNTERPART)
    assert jax == (port & jax) | set(NO_COUNTERPART)
    assert port <= jax  # the port keeps JAX's names
    assert all(reason.strip() for reason in NO_COUNTERPART.values())
    assert len({r.name for r in RULES}) == len(RULES)
    for rule in RULES:
        assert rule.description and rule.default_severity == "error"


BAD_SYNC = """
def build(x, stream):
    def fn():
        x.add_(x.sum().item()){comment}
    return PhaseGraph("p", fn, stream=stream)
"""


@pytest.mark.parametrize("comment, suppressed", [
    ("", False),
    ("  # graftlint: disable=host-sync-in-jit the warm-up reads it", True),
    ("  # graftlint: disable=print-in-jit unlike host-sync-in-jit", False),
])
def test_suppression_on_the_line(comment, suppressed):
    found = lint(BAD_SYNC.format(comment=comment))
    assert (found == []) == suppressed


def test_suppression_above_and_file_wide():
    above = BAD_SYNC.format(comment="").replace(
        "        x.add_(",
        "        # graftlint: disable=host-sync-in-jit reason\n"
        "        x.add_(")
    assert lint(above) == []
    whole = "# graftlint: disable-file=host-sync-in-jit\n" + BAD_SYNC.format(
        comment="")
    assert lint(whole) == []


def test_syntax_error_is_a_violation():
    (v,) = lint("def broken(:\n    pass\n")
    assert v.rule == "syntax-error" and v.severity == "error"
    assert isinstance(v, Violation) and "does not parse" in v.message


def test_config_reads_the_pyproject_block_and_downgrades():
    config = load_config(REPO)
    assert isinstance(config, GraftlintConfig)
    assert config.exclude == ()
    for rule in rule_names():  # no port rule is downgraded
        assert config.rule_severity(rule, "error") == "error"
    src = textwrap.dedent(BAD_SYNC.format(comment=""))
    warn = config_from_dict({"severity": {"host-sync-in-jit": "warn"}})
    assert [v.severity for v in lint_source(src, "f.py", warn)] == ["warn"]
    off = config_from_dict({"severity": {"host-sync-in-jit": "off"}})
    assert lint_source(src, "f.py", off) == []
    with pytest.raises(ValueError):
        config_from_dict({"severity": {"host-sync-in-jit": "loud"}}
                         ).rule_severity("host-sync-in-jit", "error")


# ---------------------------------------------------------------------------
# The CLI: pure AST, JAX's flags and exit codes
# ---------------------------------------------------------------------------

CLI = [sys.executable, "-m", "marl_distributedformation_tpu_torch.analysis"]


def _cli(*args):
    return subprocess.run([*CLI, *map(str, args)], cwd=REPO,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("tree, rc", [
    ("item", 1), ("clean", 0), ("syntax", 1)])
def test_cli_check_exit_codes(tree, rc, tmp_path):
    body = {
        "item": "x.add_(x.sum().item())",
        "clean": "x.add_(x.sum())",
        "syntax": "x.add_(",
    }[tree]
    (tmp_path / "phase.py").write_text(textwrap.dedent(f"""
        def build(x, stream):
            def fn():
                {body}
            return PhaseGraph("p", fn, stream=stream)
        """))
    out = _cli("--check", tmp_path)
    assert out.returncode == rc, out.stdout + out.stderr
    expected = {"item": "[host-sync-in-jit]", "clean": "0 error(s)",
                "syntax": "[syntax-error]"}[tree]
    assert expected in out.stdout
    # Without --check a finding is a report, not a failure.
    assert _cli(tmp_path).returncode == 0


def test_cli_sarif_and_rule_list_import_no_torch(tmp_path):
    (tmp_path / "phase.py").write_text(textwrap.dedent(BAD_SYNC.format(
        comment="")))
    out = _cli("--format", "sarif", tmp_path)
    doc = json.loads(out.stdout)
    (result,) = doc["runs"][0]["results"]
    assert result["ruleId"] == "host-sync-in-jit"
    assert result["locations"][0]["physicalLocation"]["region"] == {
        "startLine": 4, "startColumn": 16}
    assert [r["id"] for r in doc["runs"][0]["tool"]["driver"]["rules"]] \
        == rule_names()
    listed = _cli("--list-rules").stdout.split()
    assert listed == rule_names()
    probe = subprocess.run(
        [sys.executable, "-c",
         "import sys, runpy\n"
         "sys.argv = ['graftlint', '--list-rules']\n"
         "try:\n"
         "    runpy.run_module('marl_distributedformation_tpu_torch"
         ".analysis', run_name='__main__')\n"
         "except SystemExit:\n"
         "    pass\n"
         "print('torch' in sys.modules, 'numpy' in sys.modules)"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert probe.stdout.split()[-2:] == ["False", "False"], probe.stderr


# ---------------------------------------------------------------------------
# The port's package, linted once
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def package_lint():
    violations = lint_paths([PACKAGE], load_config(REPO), root=REPO)
    probe = PACKAGE / "train" / "capture.py"
    src = probe.read_text()
    from marl_distributedformation_tpu_torch.analysis.linter import (
        ModuleContext,
    )

    ctx = ModuleContext(ast.parse(src), src, str(probe))
    return violations, callgraph.ENGINE.package_for(ctx)


def test_the_package_is_clean(package_lint):
    violations, _ = package_lint
    assert violations == [], "\n".join(map(str, violations))


def test_the_package_graph_sees_the_captures_and_the_port_locks(
        package_lint):
    _, pg = package_lint
    captured = {
        (Path(path).relative_to(PACKAGE).as_posix(), via.split(" ")[0])
        for path, funcs in pg.captured().items() for via in funcs.values()}
    modules = {m for m, _ in captured}
    assert {"train/iteration.py", "algo/ppo.py", "scenarios/matrix.py",
            "serving/engine.py", "serving/sharded.py",
            "train/sebulba/driver.py"} <= modules, modules
    acquired = {a.lock.key for m in pg.modules.values() for f in m.funcs
                for a in f.acquires}
    assert {"_CAPTURE_LOCK", "_STREAMS_LOCK",
            "BucketedPolicyEngine._lock"} <= acquired, acquired
