"""scripts/torch_endurance.py, the port's endurance run, on the CPU.

A TINY chain to step 4 in fresh-process segments of 2 steps (the second one
through `train --restore`), scored every 2 steps on one 16-frame clip:
`scores.jsonl` holds one record per scored step and the last line of stdout
is the verdict, whose checks are the JAX script's (scripts/endurance.py);
whether it passes is not asserted (4 steps do not train a model).  Run
again on the same directory, the chain resumes at step 4 and trains
nothing.
"""

import ast
import json
import os


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _checks(path):
    """The keys of the dict literal assigned to `checks` in `path`."""
    for node in ast.walk(ast.parse(open(path).read())):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "checks" and isinstance(node.value, ast.Dict)):
            return [k.value for k in node.value.keys]
    raise AssertionError(f"no checks in {path}")


def test_tiny_chain_writes_scores_and_a_verdict(tmp_path, capsys, monkeypatch):
    import importlib.util

    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    spec = importlib.util.spec_from_file_location(
        "torch_endurance", os.path.join(REPO, "scripts", "torch_endurance.py"))
    endurance = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(endurance)
    work = tmp_path / "endurance"
    argv = ["--config", "tiny", "--target", "4", "--segment", "2", "--score-every", "2",
            "--clips", "1", "--frames", "16", "--examples", "8", "--device", "cpu",
            "--workdir", str(work)]
    rc = endurance.main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    verdict = json.loads(out[-1])
    assert rc == (0 if verdict["pass"] else 1)
    assert [ln for ln in out if ln.startswith("segment: ") and "->" in ln] == [
        "segment: 0 -> 2 / 4", "segment: 2 -> 4 / 4"]
    assert list(verdict["checks"]) == _checks(os.path.join(REPO, "scripts", "endurance.py"))
    assert verdict["pass"] == all(verdict["checks"].values())
    assert (verdict["target"], verdict["step_size"]) == (4, 1)
    assert [s["iter"] for s in verdict["scores"]] == [2, 4]

    with open(work / "scores.jsonl") as f:
        records = [json.loads(ln) for ln in f]
    assert [r["iter"] for r in records] == [2, 4]
    for r in records:
        assert len(r["clips"]) == 1 and r["clips"][0]["video"] == "endur0.avi"
        for key in ("mean_stability", "mean_stability_input", "mean_distortion",
                    "min_distortion", "mean_cropping"):
            assert 0 < r[key] <= 1 + 1e-6, key
    log = (work / "endurance.log").read_text()
    assert log.count("--restore") == 1 and "saved checkpoint step=4" in log
    assert sorted(os.listdir(work / "model")) == ["2", "4"]

    rc_again = endurance.main(argv)
    again = capsys.readouterr().out.strip().splitlines()
    assert again[0] == "resuming endurance chain from step 4"
    assert not [ln for ln in again if ln.startswith("segment")]
    assert json.loads(again[-1]) == verdict and rc_again == rc
