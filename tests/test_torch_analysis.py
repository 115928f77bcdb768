"""The port's analysis instruments, runtime lockdep and the contract lint,
against the JAX package's.

Case for case with the JAX package's ``tests/test_analysis.py``.  Lockdep
runs through the ``port_lockdep`` fixture below (the port's lockdep
installed fresh, reset, uninstalled after), with locks allocated from this
file, which the site filter keeps in scope.  The lint cases build fixture
trees with their own mini registries and run both packages' lint on each:
the same findings (check, path, line), the port's metric message naming
its registry doc.  Then the port's own tree: its registries are the port's
(``obs/hooks.py``, ``conf.py``, ``elements/query.py``), it lints clean
against ``docs/torch-observability.md``, and its baseline holds only
findings with a stated reason.
"""

import json
import os
import queue
import socket
import subprocess
import sys
import threading
import time

import pytest

from nnstreamer_tpu.analysis import lint as jlint

from nnstreamer_tpu_torch.analysis import lint, lockdep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def port_lockdep():
    """The port's lockdep for one test, on a clean slate; uninstalled after
    (kept, and only reset, if the whole run is already under it)."""
    fresh = lockdep.install()
    saved_allow = list(lockdep._allow_patterns)
    lockdep.reset()
    yield lockdep
    if fresh:
        lockdep.uninstall()
    else:
        lockdep._allow_patterns[:] = saved_allow
        lockdep.reset()


# ---------------------------------------------------------------------------
# lockdep


class TestLockdep:
    def test_seeded_abba_cycle_detected(self, port_lockdep):
        a = threading.Lock()
        b = threading.Lock()

        def ab():
            with a:
                with b:
                    time.sleep(0.001)

        def ba():
            with b:
                with a:
                    time.sleep(0.001)

        for target in (ab, ba):
            t = threading.Thread(target=target)
            t.start()
            t.join(timeout=30)
        cycles = lockdep.report()["cycles"]
        assert len(cycles) == 1, lockdep.format_report()
        assert any("test_torch_analysis.py" in s for s in cycles[0]["sites"])
        assert len(cycles[0]["witnesses"]) == 2
        t = threading.Thread(target=ba)
        t.start()
        t.join(timeout=30)
        assert len(lockdep.report()["cycles"]) == 1  # deduped

    def test_clean_hierarchy_reports_nothing(self, port_lockdep):
        a = threading.Lock()
        b = threading.Lock()

        def ordered():
            for _ in range(3):
                with a:
                    with b:
                        pass

        threads = [threading.Thread(target=ordered) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        rep = lockdep.report()
        assert rep["cycles"] == [] and rep["blocking_calls"] == []
        assert rep["edges"] >= 1

    def test_blocking_queue_get_under_lock(self, port_lockdep):
        lock = threading.Lock()
        q = queue.Queue()
        q.put("ready")
        with lock:
            q.get()
        found = lockdep.findings("blocking_call_under_lock")
        assert any(f["call"] == "queue.get" for f in found), found
        lockdep.reset()
        q.put("again")
        with lock:
            q.get(timeout=5)
        assert lockdep.findings("blocking_call_under_lock") == []

    def test_blocking_socket_recv_under_lock(self, port_lockdep):
        lock = threading.Lock()
        s1, s2 = socket.socketpair()
        try:
            s1.sendall(b"x")
            with lock:
                s2.recv(1)
            found = lockdep.findings("blocking_call_under_lock")
            assert any(f["call"] == "socket.recv" for f in found), found
            lockdep.reset()
            s1.sendall(b"y")
            s2.settimeout(5)
            with lock:
                s2.recv(1)
            assert lockdep.findings("blocking_call_under_lock") == []
        finally:
            s1.close()
            s2.close()

    def test_subprocess_wait_under_lock(self, port_lockdep):
        lock = threading.Lock()
        with lock:
            subprocess.run([sys.executable, "-c", "pass"], check=True)
        found = lockdep.findings("blocking_call_under_lock")
        assert any(f["call"] == "subprocess.wait" for f in found), found

    def test_blocked_while_holding(self, port_lockdep):
        lockdep._block_ms = 20
        outer = threading.Lock()
        inner = threading.Lock()
        started = threading.Event()

        def holder():
            with inner:
                started.set()
                time.sleep(0.15)

        t = threading.Thread(target=holder)
        t.start()
        assert started.wait(timeout=30)
        with outer:
            with inner:
                pass
        t.join(timeout=30)
        found = lockdep.findings("blocked_while_holding")
        assert found and found[0]["waited_ms"] >= 20, found

    def test_allow_suppresses_and_counts(self, port_lockdep):
        lockdep.allow("test_torch_analysis.py")
        a = threading.Lock()
        b = threading.Lock()

        def ab():
            with a:
                with b:
                    pass

        def ba():
            with b:
                with a:
                    pass

        for target in (ab, ba):
            t = threading.Thread(target=target)
            t.start()
            t.join(timeout=30)
        rep = lockdep.report()
        assert rep["cycles"] == [] and rep["suppressed"] == 1

    def test_condition_event_rlock_still_work(self, port_lockdep):
        done = threading.Event()
        cv = threading.Condition()
        rl = threading.RLock()
        with rl:
            with rl:
                pass

        def waker():
            with cv:
                cv.notify_all()
            done.set()

        t = threading.Thread(target=waker)
        with cv:
            t.start()
            cv.wait(timeout=5)
        assert done.wait(timeout=5)
        t.join(timeout=30)
        assert lockdep.report()["cycles"] == []

    def test_env_activation_and_uninstall(self, monkeypatch):
        if lockdep.installed():
            pytest.skip("the whole run is under NNSTPU_LOCKDEP")
        monkeypatch.setenv("NNSTPU_LOCKDEP", "0")
        assert lockdep.maybe_install() is False
        monkeypatch.setenv("NNSTPU_LOCKDEP", "1")
        assert lockdep.maybe_install() is True
        try:
            assert lockdep.installed()
            assert lockdep.maybe_install() is False  # idempotent
        finally:
            lockdep.uninstall()
        assert not lockdep.installed()
        assert threading.Lock is not lockdep._make_lock

    def test_conf_activation(self, monkeypatch):
        from nnstreamer_tpu_torch.conf import Conf

        if lockdep.installed():
            pytest.skip("the whole run is under NNSTPU_LOCKDEP")
        monkeypatch.delenv("NNSTPU_LOCKDEP", raising=False)
        monkeypatch.setenv("NNSTPU_ANALYSIS_LOCKDEP", "true")
        assert Conf().get_bool("analysis", "lockdep") is True
        assert lockdep.maybe_install() is True
        try:
            assert lockdep.installed()
        finally:
            lockdep.uninstall()

    def test_format_report_mentions_everything(self, port_lockdep):
        lock = threading.Lock()
        q = queue.Queue()
        q.put(1)
        with lock:
            q.get()
        text = lockdep.format_report()
        assert "BLOCKING-CALL" in text and "queue.get" in text

    def test_findings_land_in_the_flight_recorder(self, port_lockdep):
        from nnstreamer_tpu_torch.obs import spans

        spans.enable(1024)
        try:
            lock = threading.Lock()
            q = queue.Queue()
            q.put(1)
            with lock:
                q.get()
            instants = [r for r in spans.snapshot()
                        if r[0] == spans.PH_INSTANT and r[4] == "lockdep:blocking_call_under_lock"]
            assert instants and instants[0][5] == "lockdep"
        finally:
            spans.disable()
            spans.reset()

    def test_port_import_installs_under_the_env(self):
        """``NNSTPU_LOCKDEP=1``: importing the port installs lockdep before
        its modules load, and a pipeline with a queue runs clean."""
        code = ("import nnstreamer_tpu_torch as nns\n"
                "from nnstreamer_tpu_torch.analysis import lockdep\n"
                "assert lockdep.installed()\n"
                "p = nns.parse_launch('videotestsrc num-buffers=8 width=4 height=4 ! "
                "tensor_converter ! queue ! tensor_sink name=out collect=true')\n"
                "p.run(timeout=60)\n"
                "rep = lockdep.report()\n"
                "assert len(p['out'].frames) == 8 and rep['sites'] > 10, rep\n"
                "print(len(rep['cycles']))\n")
        env = dict(os.environ, NNSTPU_LOCKDEP="1")
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             cwd=REPO, env=env, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "0"


# ---------------------------------------------------------------------------
# lint fixtures (the JAX package's, run through both packages' lint)


def _write_tree(root, files):
    for rel, content in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(content)
    return str(root)


_REGISTRIES = {
    "pkg/hooks.py": (
        'HOOK_SIGNATURES = {\n'
        '    "pad_push": ("pad", "item"),\n'
        '    "error": ("pipeline", "node", "exc"),\n'
        '}\n'
    ),
    "pkg/conf.py": (
        'DEFAULTS = {\n'
        '    "common": {"tracers": "", "metrics_port": ""},\n'
        '    "obs": {"buckets": ""},\n'
        '}\n'
        'SHORT_ENV = {\n'
        '    "NNSTPU_CONF": None,\n'
        '    "NNSTPU_TRACERS": ("common", "tracers"),\n'
        '}\n'
    ),
    "pkg/query.py": (
        'class QueryError(RuntimeError):\n'
        '    code = ""\n'
        'class OverloadError(QueryError):\n'
        '    code = "OVERLOAD"\n'
        'ERROR_TYPES = {"OVERLOAD": OverloadError}\n'
        'def send_error(sock, msg, code=""):\n'
        '    pass\n'
    ),
    "docs/observability.md": (
        "metrics: `nnstpu_good_total`, the `nnstpu_fam_*` family.\n"
        "knobs: `tracers`, `metrics_port`, `buckets`; env `NNSTPU_CONF`.\n"
    ),
}


def _clean_code():
    return {
        "pkg/app.py": (
            "import threading\n"
            "from . import hooks\n"
            "from .conf import conf\n"
            "def go(reg, sock):\n"
            '    hooks.emit("pad_push", sock, 1)\n'
            '    reg.counter("nnstpu_good_total", "h")\n'
            '    reg.gauge("nnstpu_fam_depth", "h")\n'
            '    conf.get("common", "tracers")\n'
            '    t = threading.Thread(target=go, daemon=True)\n'
            "    t.start()\n"
        ),
    }


def _both(root, checks=None):
    """The port's findings, held against the JAX package's on the tree."""
    ours = lint.run_checks(root, checks)
    theirs = jlint.run_checks(root, checks)
    assert [(f.check, f.path, f.line) for f in ours] == [
        (f.check, f.path, f.line) for f in theirs]
    for a, b in zip(ours, theirs):
        if a.check != "metrics" or "is not documented" not in a.message:
            assert a.message == b.message
    return ours


class TestLintFixtures:
    def test_clean_tree_has_no_findings(self, tmp_path):
        root = _write_tree(tmp_path, {**_REGISTRIES, **_clean_code()})
        assert _both(root) == []

    @pytest.mark.parametrize("code,check,fragment", [
        ('hooks.emit("ghost", 1)\n', "hooks", "unregistered hook"),
        ('hooks.emit("pad_push", 1)\n', "hooks", "1 args"),
        ('hooks.emit("error", 1, 2, 3, 4)\n', "hooks", "3"),
        ('reg.counter("nnstpu_ghost_total", "h")\n', "metrics", "not documented"),
        ('conf.get("ghost_sec", "x")\n', "conf", "unknown section"),
        ('conf.get_int("obs", "ghost_key", 1)\n', "conf", "no DEFAULTS"),
        ('import os\nos.environ.get("NNSTPU_GHOST_THING")\n', "conf", "no DEFAULTS knob"),
        ('send_error(None, "x", code="GHOST")\n', "wire-codes", "not registered"),
        ('import threading\nthreading.Thread(target=print).start()\n', "threads",
         "fire-and-forget"),
        ('try:\n    pass\nexcept:\n    pass\n', "bare-except", "bare 'except:'"),
    ])
    def test_seeded_violation_fires(self, tmp_path, code, check, fragment):
        files = {**_REGISTRIES, **_clean_code()}
        files["pkg/bad.py"] = ("from . import hooks\nfrom .conf import conf\n"
                               "from .query import send_error\n" + code)
        root = _write_tree(tmp_path, files)
        found = [f for f in _both(root) if f.check == check]
        assert found and any(fragment in f.message for f in found)

    def test_stale_doc_metric_and_uncarried_wire_code(self, tmp_path):
        files = {**_REGISTRIES, **_clean_code()}
        files["docs/observability.md"] += "gone: `nnstpu_stale_total`.\n"
        files["pkg/query.py"] = (
            'class QueryError(RuntimeError):\n'
            '    code = ""\n'
            'class OverloadError(QueryError):\n'
            '    code = "OVERLOAD"\n'
            'ERROR_TYPES = {"OVERLOAD": OverloadError,\n'
            '               "PHANTOM": OverloadError}\n'
            'def send_error(sock, msg, code=""):\n'
            '    pass\n')
        root = _write_tree(tmp_path, files)
        msgs = [f.message for f in _both(root)]
        assert any("nnstpu_stale_total" in m and "does not exist" in m for m in msgs)
        assert any("PHANTOM" in m and "no exception class" in m for m in msgs)

    def test_arity_splat_and_wildcards_do_not_fire(self, tmp_path):
        files = {**_REGISTRIES, **_clean_code()}
        files["pkg/ok.py"] = (
            "from . import hooks\n"
            "def go(args, reg):\n"
            '    hooks.emit("error", *args)\n'
            '    reg.counter("nnstpu_fam_hits_total", "h")\n')
        root = _write_tree(tmp_path, files)
        assert _both(root) == []

    def test_threads_joined_via_loop_and_return(self, tmp_path):
        files = {**_REGISTRIES, **_clean_code()}
        files["pkg/ok.py"] = (
            "import threading\n"
            "def spawn_threads():\n"
            "    return [threading.Thread(target=print)]\n"
            "def fleet():\n"
            "    ts = [threading.Thread(target=print) for _ in range(3)]\n"
            "    for t in ts:\n"
            "        t.start()\n"
            "    for t in ts:\n"
            "        t.join()\n"
            "def owned(self):\n"
            "    self._t = threading.Thread(target=print)\n"
            "    self._t.start()\n"
            "    self._t.join()\n")
        root = _write_tree(tmp_path, files)
        assert [f for f in _both(root) if f.check == "threads"] == []

    def test_suppressions_same_line_and_next_line(self, tmp_path):
        files = {**_REGISTRIES, **_clean_code()}
        files["pkg/sup.py"] = (
            "from . import hooks\n"
            'hooks.emit("ghost", 1)  # nnslint: disable=hooks\n'
            "# nnslint: disable-next-line=bare-except\n"
            "try:\n"
            "    pass\n"
            "except:\n"
            "    pass\n")
        root = _write_tree(tmp_path, files)
        found = _both(root)
        assert all(f.check != "hooks" for f in found)
        assert any(f.check == "bare-except" for f in found)  # line-accurate
        files["pkg/sup.py"] = (
            "from . import hooks\n"
            'hooks.emit("ghost", 1)  # nnslint: disable=all\n'
            "try:\n"
            "    pass\n"
            "except:  # nnslint: disable=bare-except\n"
            "    pass\n")
        root = _write_tree(tmp_path, files)
        assert _both(root) == []

    def test_baseline_round_trip(self, tmp_path):
        files = {**_REGISTRIES, **_clean_code()}
        files["pkg/bad.py"] = 'from . import hooks\nhooks.emit("ghost", 1)\n'
        root = _write_tree(tmp_path, files)
        findings = lint.run_checks(root)
        assert len(findings) == 1
        bl_path = os.path.join(root, ".nnslint-baseline.json")
        lint.write_baseline(bl_path, findings, {findings[0].fingerprint: "a test fixture"})
        baseline = lint.load_baseline(bl_path)
        assert lint.load_reasons(bl_path) == {findings[0].fingerprint: "a test fixture"}
        new, resolved = lint.partition(lint.run_checks(root), baseline)
        assert new == [] and resolved == set()
        files["pkg/bad.py"] += 'hooks.emit("ghost2", 1)\n'
        _write_tree(tmp_path, files)
        new, _ = lint.partition(lint.run_checks(root), baseline)
        assert len(new) == 1 and "ghost2" in new[0].message
        files["pkg/bad.py"] = 'from . import hooks\nhooks.emit("ghost2", 1)\n'
        _write_tree(tmp_path, files)
        new, resolved = lint.partition(lint.run_checks(root), baseline)
        assert len(new) == 1 and len(resolved) == 1
        files["pkg/bad.py"] = ('from . import hooks\n# pad\n# pad\n'
                               'hooks.emit("ghost", 1)\n')
        _write_tree(tmp_path, files)
        new, _ = lint.partition(lint.run_checks(root), baseline)
        assert new == []

    def test_unknown_check_rejected(self, tmp_path):
        root = _write_tree(tmp_path, _REGISTRIES)
        with pytest.raises(ValueError, match="unknown checks"):
            lint.run_checks(root, ["ghost-check"])

    def test_paths_and_docs_narrow_the_walk(self, tmp_path):
        """``paths`` walks only the named directories; ``docs`` replaces the
        walk's .md files (a metric documented only elsewhere fires)."""
        files = {**_REGISTRIES, **_clean_code(), "other/bad.py": "try:\n    pass\nexcept:\n    pass\n",
                 "notes/registry.md": "`nnstpu_good_total`\n"}
        root = _write_tree(tmp_path, files)
        assert any(f.path == "other/bad.py" for f in lint.run_checks(root))
        found = lint.run_checks(root, paths=["pkg"], docs=["notes/registry.md"])
        assert not any(f.path.startswith("other/") for f in found)
        assert any("nnstpu_fam_depth" in f.message for f in found)
        undocumented = [f for f in found if "DEFAULTS knob" in f.message]
        assert undocumented and all(f.path == "pkg/conf.py" for f in undocumented)


# ---------------------------------------------------------------------------
# the port's tree and CLI


class TestPortTree:
    def test_registries_are_the_ports(self):
        from nnstreamer_tpu_torch import conf
        from nnstreamer_tpu_torch.elements.query import ERROR_TYPES
        from nnstreamer_tpu_torch.obs.hooks import HOOK_SIGNATURES

        tree = lint.LintTree(REPO, paths=["nnstreamer_tpu_torch"],
                             docs=["docs/torch-observability.md"])
        assert tree.errors == []
        assert tree.hook_signatures == {k: len(v) for k, v in HOOK_SIGNATURES.items()}
        assert tree.defaults == conf.DEFAULTS
        assert tree.defaults_loc[0] == "nnstreamer_tpu_torch/conf.py"
        assert set(tree.error_types) == set(ERROR_TYPES)
        assert {k: v for k, v in tree.short_env.items()} == conf.SHORT_ENV
        assert all(not pf.path.startswith("nnstreamer_tpu/") for pf in tree.py)

    def test_port_lints_clean_against_its_registry_doc(self):
        found = lint.run_checks(REPO, paths=["nnstreamer_tpu_torch"],
                                docs=["docs/torch-observability.md"])
        with open(os.path.join(REPO, "nnstreamer_tpu_torch", "tools",
                               "nnslint_baseline.json"), encoding="utf-8") as fh:
            baseline = json.load(fh)
        accepted = set(baseline["findings"])
        assert [str(f) for f in found if f.fingerprint not in accepted] == []
        assert all(baseline["reasons"].get(fp, "").strip() for fp in accepted)


class TestNnslintCLI:
    def _run(self, *args):
        return subprocess.run([sys.executable, "-m", "nnstreamer_tpu_torch.tools.nnslint", *args],
                              capture_output=True, text=True, timeout=120, cwd=REPO)

    def test_shipped_port_is_clean(self):
        res = self._run()
        assert res.returncode == 0, res.stdout + res.stderr
        assert "0 new" in res.stdout

    def test_seeded_tree_fails_and_baseline_gates(self, tmp_path):
        root = _write_tree(tmp_path, {
            **_REGISTRIES, **_clean_code(),
            "pkg/bad.py": 'from . import hooks\nhooks.emit("ghost", 1)\n',
        })
        res = self._run("--root", root, "--no-baseline")
        assert res.returncode == 1 and "ghost" in res.stdout
        res = self._run("--root", root, "--write-baseline")
        assert res.returncode == 0
        # accepted without a reason: the gate still fails
        res = self._run("--root", root)
        assert res.returncode == 1 and "without a reason" in res.stdout
        path = os.path.join(root, ".nnslint-baseline.json")
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
        doc["reasons"] = {fp: "the fixture's seeded finding" for fp in doc["findings"]}
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
        res = self._run("--root", root)
        assert res.returncode == 0, res.stdout
        res = self._run("--root", root, "--format", "json")
        doc = json.loads(res.stdout)
        assert doc["findings"][0]["new"] is False
        assert doc["findings"][0]["reason"] == "the fixture's seeded finding"

    def test_list_checks(self):
        res = self._run("--list-checks")
        assert res.returncode == 0
        assert set(res.stdout.split()) == set(lint.ALL_CHECKS) == set(jlint.ALL_CHECKS)
