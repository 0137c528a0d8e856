"""Cells small enough for the CPU, for the benchmark's own tests."""
import json

# every algorithm the grid driver and the plain reference serve
ALGOS = ("balanced_pandas_pod", "balanced_pandas", "jsq_maxweight_pod")
TINY = {"M": 40, "K": 4, "loads": [0.5, 0.95]}


def tiny(workload: str, T: int = 200, algo: str = None) -> tuple:
    """(config, traffic) of ``workload`` cut to 40 servers, 2 loads x 2
    seeds and T slots, every rate and width of the configuration kept;
    ``algo`` in place of the traffic's algorithm."""
    from portbench import harness
    spec = harness.load_spec()
    entry = next(w for w in spec["workloads"] if w["name"] == workload)
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    config = {**json.loads((harness.ROOT / conf["file"]).read_text()), **TINY,
              "T": T, "warmup": T // 4}
    traffic = json.loads((harness.HERE / "traffic" / f"{entry['traffic']}.json").read_text())
    traffic.update(n_seeds=2, **({"algo": algo} if algo else {}))
    if traffic["algo"].startswith("jsq"):
        config["s_max"] = 16         # fewer rows than servers, as at full size
    return config, traffic


def driver(traffic: dict):
    """The driver module a traffic mix names."""
    from portbench import harness
    name = traffic["driver"]
    return harness.load_module(harness.HERE / "drivers" / f"{name}.py", f"portbench_driver_{name}")
