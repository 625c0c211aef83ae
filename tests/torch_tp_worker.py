"""One rank of the port's tensor-parallel CPU tests (``tests/
test_torch_parallel.py``), run as a process of its own:

    python tests/torch_tp_worker.py CASES RANK WORLD ADDRESS OUT

It joins a gloo world of ``WORLD`` ranks at ``ADDRESS`` (``tcp://host:port``),
builds the meshes ``dp2tp2`` (dp=2 x tp=2) and ``tp4`` (tp=4), runs every
case of the ``torch.save``'d list ``CASES`` on its mesh, and saves each
case's results to ``OUT`` (``torch.save``: a dict of case name -> result,
or the text of the exception where the case expects one). It imports
torch and the port only, never JAX, and runs torch on one thread.
"""
import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from any4_tpu_torch.models import llama, mixtral  # noqa: E402
from any4_tpu_torch.parallel import distributed, tp  # noqa: E402
from any4_tpu_torch.serving import engine as teng  # noqa: E402

FORWARDS = {"llama": llama.forward, "mixtral": mixtral.forward}


def forward(case, mesh):
    local, specs = tp.shard_params(case["params"], mesh, cfg=case["cfg"])
    fn = tp.make_tp_forward(case["cfg"], mesh, specs,
                            forward_fn=FORWARDS[case["model"]])
    return fn(local, case["ids"])


def decode(case, mesh):
    """Two decode steps with the cache: the logits of each."""
    cfg = case["cfg"]
    local, specs = tp.shard_params(case["params"], mesh)
    step = tp.make_tp_forward(cfg, mesh, specs, with_cache=True)
    b = case["tokens"].shape[1]
    caches = llama.init_kv_caches(tp.local_config(cfg, mesh.tp),
                                  b // mesh.dp, case["max_len"],
                                  device="cpu")
    out = []
    for pos, tok in enumerate(case["tokens"]):
        logits, caches = step(local, tok, pos, caches)
        out.append(logits)
    return torch.stack(out)


def serve(case, mesh):
    """The TP engine's tokens for the case's prompts, and the TP forward's
    teacher-forced logits along the single engine's tokens
    (``case["along"]``, right-padded as ``case["forced_ids"]``)."""
    local, specs = tp.shard_params(case["params"], mesh, cfg=case["cfg"])
    e = teng.Engine(local, case["cfg"], mesh=mesh, param_spec=specs,
                    device="cpu", **case["engine"])
    uids = [e.submit(p, max_new_tokens=case["max_new"])
            for p in case["prompts"]]
    done = {r.uid: list(r.out_tokens) for r in e.run(**case["run"])}
    fn = tp.make_tp_forward(case["cfg"], mesh, specs)
    return {"tokens": [done[u] for u in uids],
            "forced": fn(local, case["forced_ids"])}


def stacked(case, mesh):
    local, specs = tp.shard_params(case["params"], mesh)
    return tp.make_tp_forward(case["cfg"], mesh, specs,
                              forward_fn=mixtral.forward)(local,
                                                          case["ids"])


def bad_mesh(case, mesh):
    return tp.make_mesh(dp=3, tp=4, device="cpu")


RUNS = {"forward": forward, "decode": decode, "serve": serve,
        "stacked": stacked, "bad_mesh": bad_mesh}


def main():
    cases_path, rank, world, address, out_path = sys.argv[1:6]
    torch.set_num_threads(1)
    torch.manual_seed(0)
    if not distributed.initialize(address, int(world), int(rank)):
        raise RuntimeError("initialize joined no process group")
    meshes = {"dp2tp2": tp.make_mesh(dp=2, tp=2, device="cpu"),
              "tp4": tp.make_mesh(dp=1, tp=4, device="cpu")}
    cases = torch.load(cases_path, weights_only=False)
    results = {}
    for case in cases:
        try:
            results[case["name"]] = RUNS[case["run_as"]](
                case, meshes[case["mesh"]])
        except Exception as e:  # noqa: BLE001 -- the parent reads it
            if not case.get("raises"):
                traceback.print_exc()
                raise
            results[case["name"]] = f"{type(e).__name__}: {e}"
    torch.save(results, out_path)
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank} OK", flush=True)


if __name__ == "__main__":
    main()
