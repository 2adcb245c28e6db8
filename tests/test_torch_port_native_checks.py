"""The checks of the JAX package's native core, run over the port's copy
(``horovod_tpu_torch/native``).

* The C++ unit tests (``native/unit_tests.cpp``, a copy of the JAX
  package's with the core linked in and cases for the copy's two
  deviations: the negotiated shutdown and the join that re-runs the
  promotion), built by ``utils/native_build.py`` plain and under
  ``-fsanitize=thread``: ``ALL OK``, and no ThreadSanitizer report.
* ``scripts/check_threadroles.py`` and ``scripts/check_invariants.py``,
  unedited, pointed at a scratch tree that is the JAX package's Python
  files with the port's ``native`` in its place and the port's mirrors of
  the control-plane tags (``_CTRL_MSGS``, ``_RESPONSE_TYPES`` of
  ``horovod_tpu_torch/basics.py``, which hold the negotiated shutdown's)
  in ``basics.py``: every rule runs, and none reports a finding.
"""

import ast
import glob
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVIATIONS = ("TestShmCleanCloseLeavesPeerReading", "TestCoreJoinAtWorldOne",
              "TestCoreJoinCompletesWaitingRequest",
              "TestCoreNegotiatedShutdown")


@pytest.fixture(scope="module")
def unit_tests():
    """Both binaries, built at the same time (one g++ a source each)."""
    import concurrent.futures

    from horovod_tpu_torch.utils import native_build
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(native_build.build_unit_tests, tsan)
                  for tsan in (False, True)]
        return [b.result() for b in builds]


@pytest.mark.parametrize("tsan", (False, True), ids=("plain", "tsan"))
def test_unit_tests_pass(tsan, unit_tests):
    from horovod_tpu_torch.utils import native_build
    proc = native_build.run_unit_tests(tsan=tsan, timeout=600)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]
    assert "native unit tests: ALL OK" in proc.stdout
    for line in out.splitlines():
        assert "ThreadSanitizer" not in line, line


def test_unit_tests_cover_the_deviations():
    """The copy holds the JAX package's cases and runs the four new ones
    from ``main``."""
    from horovod_tpu_torch.utils import native_build
    port = native_build.UNIT_TESTS.read_text()
    main = port[port.index("int main()"):]
    for name in DEVIATIONS:
        assert f"void {name}()" in port and f"{name}();" in main, name
    jax = open(os.path.join(REPO, "horovod_tpu", "native",
                            "unit_tests.cpp")).read()
    jax_main = jax[jax.index("int main()"):]
    for call in (line.strip() for line in jax_main.splitlines()):
        if call.startswith("Test"):
            assert call in main, call


def _scratch_tree(root) -> str:
    """The JAX package's Python files, its docs and scripts, with the
    port's native copy and the port's control-plane mirrors."""
    root = str(root)
    for sub in ("docs", "scripts"):
        shutil.copytree(os.path.join(REPO, sub), os.path.join(root, sub))
    pkg = os.path.join(root, "horovod_tpu")
    shutil.copytree(os.path.join(REPO, "horovod_tpu"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "native"))
    os.makedirs(os.path.join(pkg, "native"))
    for f in glob.glob(os.path.join(REPO, "horovod_tpu_torch", "native",
                                    "*.*")):
        if f.endswith((".cpp", ".h")):
            shutil.copy(f, os.path.join(pkg, "native"))
    port = open(os.path.join(REPO, "horovod_tpu_torch", "basics.py")).read()
    mirrors = {node.targets[0].id: ast.get_source_segment(port, node)
               for node in ast.parse(port).body
               if isinstance(node, ast.Assign) and
               getattr(node.targets[0], "id", "") in ("_CTRL_MSGS",
                                                      "_RESPONSE_TYPES")}
    assert set(mirrors) == {"_CTRL_MSGS", "_RESPONSE_TYPES"}
    path = os.path.join(pkg, "basics.py")
    src = open(path).read()
    segments = [(ast.get_source_segment(src, node),
                 mirrors[node.targets[0].id])
                for node in ast.parse(src).body
                if isinstance(node, ast.Assign) and
                getattr(node.targets[0], "id", "") in mirrors]
    assert len(segments) == 2
    for old, new in segments:
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    return root


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    return _scratch_tree(tmp_path_factory.mktemp("port_native_tree"))


@pytest.mark.parametrize("script,rules", [
    ("check_threadroles.py", ("ROLE-COVERAGE", "ROLE-CALL", "SIGNAL-SAFE")),
    ("check_invariants.py", ("ENV-DECL", "ENV-DOC", "ENV-RAW", "MET-DOC",
                             "FLAG-DOC", "ENUM-MIRROR", "CtrlMsg",
                             "ResponseType", "ATOMIC-DISCIPLINE",
                             "ABI-MIRROR"))])
def test_static_checks_find_nothing(script, rules, scratch):
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", script), "--root",
         scratch], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    summary = proc.stderr.strip().splitlines()[-1]
    assert " 0 finding(s)" in summary, summary
    for rule in rules:
        assert rule in summary, (rule, summary)


def test_the_mirrors_hold_the_copys_tags():
    """Without the port's mirrors the linter sees exactly the copy's new
    tags as findings: the scratch tree's check is about them."""
    from horovod_tpu import basics as jax_basics
    from horovod_tpu_torch import basics
    assert {k: v for k, v in basics._CTRL_MSGS.items()
            if k not in jax_basics._CTRL_MSGS} == {
        "shutdown_req": 10, "shutdown_ack": 11, "shutdown_fin": 12}
    assert {k: v for k, v in basics._RESPONSE_TYPES.items()
            if k not in jax_basics._RESPONSE_TYPES} == {"clean_shutdown": 4}
    for k, v in jax_basics._CTRL_MSGS.items():
        assert basics._CTRL_MSGS[k] == v
    for k, v in jax_basics._RESPONSE_TYPES.items():
        assert basics._RESPONSE_TYPES[k] == v
