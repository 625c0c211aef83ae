"""BigCode-style code-generation evaluation: generate -> execute -> pass@k
(a copy of ``any4_tpu/evals/code_eval.py``, which uses no JAX).

The reference routes HumanEval/MBPP through bigcode-evaluation-harness
(eval.py:262-294) and reports pass@1 as a first-class result
(README.md:170-176). This is the framework-native route: completions come
from any ``generate_fn(prompt) -> completion`` (typically
``TorchCausalLM.generate_until``), candidate programs run in a subprocess
under resource limits with a timeout, and pass@k uses the unbiased estimator from the
HumanEval paper. A builtin problem set makes the route executable offline;
``load_humaneval`` uses a locally-cached copy of openai_humaneval when one
exists.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from math import comb
from typing import Callable, Dict, List, Optional, Sequence

# Truncation markers bigcode uses for completion-style code models.
STOP_WORDS = ["\ndef ", "\nclass ", "\nif __name__", "\nprint(", "\n#"]

BUILTIN_PROBLEMS = [
    {
        "task_id": "builtin/0",
        "prompt": "def add(a, b):\n"
                  "    \"\"\"Return the sum of a and b.\"\"\"\n",
        "test": "def check(f):\n"
                "    assert f(1, 2) == 3\n"
                "    assert f(-1, 1) == 0\n",
        "entry_point": "add",
    },
    {
        "task_id": "builtin/1",
        "prompt": "def is_even(n):\n"
                  "    \"\"\"Return True when n is even.\"\"\"\n",
        "test": "def check(f):\n"
                "    assert f(2) is True\n"
                "    assert f(3) is False\n",
        "entry_point": "is_even",
    },
    {
        "task_id": "builtin/2",
        "prompt": "def max3(a, b, c):\n"
                  "    \"\"\"Return the largest of three numbers.\"\"\"\n",
        "test": "def check(f):\n"
                "    assert f(1, 2, 3) == 3\n"
                "    assert f(9, 2, 3) == 9\n",
        "entry_point": "max3",
    },
    {
        "task_id": "builtin/3",
        "prompt": "def reverse_string(s):\n"
                  "    \"\"\"Return s reversed.\"\"\"\n",
        "test": "def check(f):\n"
                "    assert f('abc') == 'cba'\n"
                "    assert f('') == ''\n",
        "entry_point": "reverse_string",
    },
]


def truncate_completion(completion: str,
                        stop_words: Sequence[str] = STOP_WORDS) -> str:
    """Cut the completion at the first stop marker (bigcode's
    postprocessing for completion-style benchmarks)."""
    for stop in stop_words:
        idx = completion.find(stop)
        if idx >= 0:
            completion = completion[:idx]
    return completion


def execute_candidate(program: str, timeout: float = 10.0) -> Dict:
    """Run one candidate program in a subprocess; passed == exit code 0.

    The candidate is model-generated code: it runs in a separate process
    with a hard timeout and an empty environment, never in-process."""
    def _limits():
        import resource
        resource.setrlimit(resource.RLIMIT_AS, (2 << 30, 2 << 30))
        cpu = max(int(timeout) + 1, 2)
        resource.setrlimit(resource.RLIMIT_CPU, (cpu, cpu))
        resource.setrlimit(resource.RLIMIT_NPROC, (32, 32))

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "candidate.py")
        with open(path, "w") as f:
            f.write(program)
        try:
            proc = subprocess.run(
                [sys.executable, path], capture_output=True, text=True,
                timeout=timeout, cwd=d, env={"PYTHONHASHSEED": "0"},
                preexec_fn=_limits)
            if proc.returncode == 0:
                return {"passed": True, "result": "passed"}
            return {"passed": False,
                    "result": (proc.stderr or "error").strip()[-300:]}
        except subprocess.TimeoutExpired:
            return {"passed": False, "result": "timed out"}


def build_program(problem: Dict, completion: str) -> str:
    return (problem["prompt"] + completion + "\n\n" + problem["test"]
            + f"\ncheck({problem['entry_point']})\n")


def pass_at_k(n: int, c: int, k: int) -> float:
    """Unbiased pass@k estimator (HumanEval paper eq. 1)."""
    if n - c < k:
        return 1.0
    return 1.0 - comb(n - c, k) / comb(n, k)


def evaluate_code(generate_fn: Callable[[str], str],
                  problems: Optional[List[Dict]] = None,
                  n_samples: int = 1,
                  ks: Sequence[int] = (1,),
                  timeout: float = 10.0,
                  log_path: Optional[str] = None,
                  progress: bool = False) -> Dict:
    """Run the full generate->execute->pass@k pipeline.

    ``generate_fn(prompt)`` returns one completion; called ``n_samples``
    times per problem (greedy generators should use n_samples=1).
    """
    problems = problems if problems is not None else BUILTIN_PROBLEMS
    records = []
    totals = {k: 0.0 for k in ks}
    for prob in problems:
        n = c = 0
        cands = []
        for _ in range(n_samples):
            completion = truncate_completion(generate_fn(prob["prompt"]))
            res = execute_candidate(build_program(prob, completion),
                                    timeout=timeout)
            n += 1
            c += int(res["passed"])
            cands.append({"completion": completion, **res})
        for k in ks:
            totals[k] += pass_at_k(n, c, min(k, n))
        records.append({"task_id": prob["task_id"], "n": n, "passed": c,
                        "candidates": cands})
        if progress:
            print(f"  {prob['task_id']}: {c}/{n} passed")
    out = {f"pass@{k}": totals[k] / max(len(problems), 1) for k in ks}
    out["n_problems"] = len(problems)
    if log_path:
        with open(log_path, "w") as f:
            json.dump({"metrics": out, "records": records}, f, indent=1)
    return out


def load_humaneval(limit: Optional[int] = None) -> List[Dict]:
    """Load openai_humaneval from a local HF datasets cache (without
    network access: raises DatasetUnavailable when not cached)."""
    from .datasets import DatasetUnavailable
    try:
        import datasets as hfd
        ds = hfd.load_dataset("openai_humaneval", split="test",
                              download_mode="reuse_dataset_if_exists")
    except Exception as e:
        raise DatasetUnavailable(f"openai_humaneval unavailable: {e}") from e
    problems = [{"task_id": r["task_id"], "prompt": r["prompt"],
                 "test": r["test"], "entry_point": r["entry_point"]}
                for r in ds]
    return problems[:limit] if limit else problems


def run_code_tasks(lm, tasks: List[str], n_samples: int = 1,
                   ks: Sequence[int] = (1,), log_dir: Optional[str] = None,
                   max_gen_toks: int = 256, progress: bool = False) -> Dict:
    """Route named code tasks through an LM-protocol object (its
    ``generate_until``), mirroring the reference's BigCode task loop
    (eval.py:262-294)."""
    from .datasets import DatasetUnavailable

    def gen(prompt: str) -> str:
        reqs = [(prompt, {"until": STOP_WORDS,
                          "max_gen_toks": max_gen_toks})]
        return lm.generate_until(reqs)[0]

    results = {}
    for task in tasks:
        name = task
        if task in ("builtin", "builtin_code"):
            problems = BUILTIN_PROBLEMS
        elif task in ("humaneval", "openai_humaneval"):
            try:
                problems = load_humaneval()
            except DatasetUnavailable as e:
                if progress:
                    print(f"{task}: {e}; using builtin problems")
                name, problems = f"builtin:{task}", BUILTIN_PROBLEMS
        else:
            raise KeyError(f"unknown code task {task!r} "
                           "(have: builtin, humaneval)")
        log_path = os.path.join(log_dir, f"code_{name.replace(':', '_')}"
                                ".json") if log_dir else None
        results[name] = evaluate_code(
            gen, problems, n_samples=n_samples, ks=ks, log_path=log_path,
            progress=progress)
    return results
