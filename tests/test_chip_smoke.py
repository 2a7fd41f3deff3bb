"""Host logic of chip_smoke.py, and a guard against accelerator-specific
leftovers in the program files."""

import json
import os
import re
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_result_line_format():
    devs = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
            ] * 4
    line = chip_smoke.result_line(devs)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 4}}')
    assert json.loads(line)["device"]["count"] == 4


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_no_gpu_exits_nonzero_without_result(where, tmp_path):
    """On the CPU, or copied into a directory without the package, the
    script fails and prints no result line."""
    if where == "repo":
        script, cwd = os.path.join(REPO, "chip_smoke.py"), REPO
    else:
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), script)
        cwd = str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_four_cards_selects_only_the_mesh_phase():
    assert chip_smoke.select_phases(True) == [chip_smoke.phase_mesh]
    one = chip_smoke.select_phases(False)
    assert one == [chip_smoke.phase_operator, chip_smoke.phase_flagship,
                   chip_smoke.phase_drivers]


def test_failing_phase_raises_and_prints_no_result(monkeypatch, capsys):
    fake = [SimpleNamespace(platform="gpu", device_kind="fake")]
    ran = []

    def good(jax, card):
        ran.append("good")

    def bad(jax, card):
        raise RuntimeError("check failed: injected")

    monkeypatch.setattr(chip_smoke, "require_gpu", lambda jax, count: fake)
    monkeypatch.setattr(chip_smoke, "card_info", lambda: "fake card, 1 W")
    monkeypatch.setattr(chip_smoke, "select_phases",
                        lambda four: [good, bad, good])
    with pytest.raises(RuntimeError, match="injected"):
        chip_smoke.main([])
    assert ran == ["good"]  # nothing runs after the failure
    assert '"ok"' not in capsys.readouterr().out


def test_missing_nvidia_smi_is_an_error(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))  # no nvidia-smi on it
    with pytest.raises(RuntimeError, match="nvidia-smi"):
        chip_smoke.card_info()


# Bracketed letters keep this file from matching the patterns itself.
_FORBIDDEN = {
    "foreign_pallas_import": r"pallas\.[t]pu|pl[t]pu\b",
    "platform_branch": (r"(default_backend\(\)|platform)\s*[!=]=\s*"
                        r"[\"'][t]pu[\"']"),
    "legacy_env_variable": r"DIAGLIB_[T]PU_",
    "legacy_xla_option": r"xla_[v]f_",
    "hard_coded_interpret": r"interpret\s*=\s*[T]rue",
}


def _program_files():
    files = [os.path.join(REPO, f) for f in
             ("bench.py", "__graft_entry__.py", "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "diaglib_tpu")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


@pytest.mark.parametrize("name", sorted(_FORBIDDEN))
def test_no_accelerator_specific_leftovers(name):
    pat = re.compile(_FORBIDDEN[name])
    hits = []
    for path in _program_files():
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if pat.search(line):
                    hits.append(f"{os.path.relpath(path, REPO)}:{i}")
    assert not hits, hits
