"""``tools/graph_memory.py`` (the card's memory through a model instance's
graph sets) at CPU sizes, where it has no memory figures: each case's runs
on one instance, exact, and the command line's refusals."""

import json

import pytest
import torch

from stateright_tpu_torch.tools import graph_memory

KEYS = ("peak_allocated_gib", "peak_reserved_gib", "reserved_gib", "graph_pools_gib",
        "graph_pools_free_gib")


def test_each_structure_cold_then_warm_on_one_instance():
    lines = list(graph_memory.cases(["rm9"], torch.device("cpu"), rm=3, paxos_clients=2,
                                    paxos_depth=4))
    assert [ln["run"] for ln in lines] == [f"rm3_{d}_{p}" for d in ("sorted", "hash", "delta")
                                           for p in ("cold", "warm")]
    assert {(ln["generated"], ln["unique"], ln["max_depth"]) for ln in lines} == {(1_146, 288, 11)}
    assert all(ln["case"] == "rm9" and all(ln[k] is None for k in KEYS) for ln in lines)


def test_the_second_set_runs_on_the_first_sets_instance(capsys):
    assert graph_memory.main(["--device", "cpu", "--cases", "paxos3_two_sets",
                              "--paxos-clients", "2", "--paxos-depth", "4"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [(ln["run"], ln["max_depth"]) for ln in lines] == [("paxos3_sorted", 5),
                                                              ("paxos3_hash", 4)]
    assert lines[0]["unique"] > lines[1]["unique"] > 0


def test_unknown_cases_are_refused():
    with pytest.raises(SystemExit):
        graph_memory.main(["--device", "cpu", "--cases", "rm9,rm10"])
