"""The port's round lint (``repro_torch.launch.session_lint``): the
serving round path, the sharded fabric's included, holds no device fence
outside the sampled gate and the guard's one read; a fence put on the
round, or an allowed site renamed away, is reported."""
import shutil
from pathlib import Path

import pytest

from repro_torch.launch import session_lint

PKG = Path(session_lint.__file__).resolve().parents[1]


def _copy(tmp_path) -> Path:
    root = tmp_path / "repro_torch"
    shutil.copytree(PKG / "serving", root / "serving")
    (root / "core").mkdir()
    shutil.copy(PKG / "core" / "pipeline.py", root / "core" / "pipeline.py")
    return root


def test_the_round_path_has_no_fence_outside_the_gate():
    assert session_lint.lint(PKG) == []
    assert session_lint.main([]) == 0


@pytest.mark.parametrize("file,anchor,fn", [
    ("serving/cluster.py", "        self._exchange(tables, gather=True)\n",
     "_Shard.step"),
    ("core/pipeline.py", "        self.calls += 1\n",
     "CoalescedRound.__call__"),
    ("serving/session.py", "        launch = self._ensure_layout(width)\n",
     "SessionManager._coalesced_round"),
])
def test_a_fence_on_the_round_is_reported(tmp_path, file, anchor, fn):
    root = _copy(tmp_path)
    path = root / file
    src = path.read_text()
    assert src.count(anchor) == 1
    indent = anchor[:len(anchor) - len(anchor.lstrip())]
    path.write_text(src.replace(
        anchor, anchor + f"{indent}torch.cuda.synchronize()\n"))
    errors = session_lint.lint(root)
    assert len(errors) == 1 and f".synchronize() in {fn}" in errors[0]


def test_a_renamed_allowed_site_is_reported(tmp_path):
    root = _copy(tmp_path)
    path = root / "serving" / "session.py"
    path.write_text(path.read_text().replace("def _fence(", "def _fence2("))
    errors = session_lint.lint(root)
    assert any("allowed fence site _fence not found" in e for e in errors)
    assert any(".synchronize() in _fence2" in e for e in errors)
