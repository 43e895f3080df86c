"""Deployment topologies (paper §4.1 notation).

``-``  separates stages on distinct hardware; ``()`` co-locates stages on
one device with logical isolation; stages written together (``EP``) share
one engine serially (coupled, vLLM-style). ``TP1``/``TP2`` are the
monolithic baselines.

``parse(name)`` builds the spec for one replica; ``scale(spec, k)``
replicates it.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field, replace
from typing import List, Tuple


@dataclass(frozen=True)
class InstanceSpec:
    name: str
    stages: Tuple[str, ...]         # subset of ("E","P","D")
    chips: int = 1
    tp: int = 1
    coloc_group: int = -1           # >=0: shares physical chips with peers
    monolithic: bool = False        # stages share ONE serial execution queue

    def serves(self, stage: str) -> bool:
        return stage in self.stages


@dataclass(frozen=True)
class Deployment:
    name: str
    instances: Tuple[InstanceSpec, ...]
    n_chips: int

    def stage_instances(self, stage: str) -> List[InstanceSpec]:
        return [i for i in self.instances if i.serves(stage)]


def parse(name: str) -> Deployment:
    """Parse deployment notation: 'E-P-D', 'EP-D', '(E-P)-D', '(E-PD)',
    '(E-D)-P', 'E-PD', 'TP1', 'TP2'."""
    if name.upper().startswith("TP"):
        tp = int(name[2:])
        inst = InstanceSpec(f"mono_tp{tp}", ("E", "P", "D"), chips=tp, tp=tp,
                            monolithic=True)
        return Deployment(name, (inst,), tp)

    instances: List[InstanceSpec] = []
    chips = 0
    coloc = 0
    # split on '-' that are not inside parentheses
    units = re.findall(r"\([^)]*\)|[^-()]+", name)
    for unit in units:
        unit = unit.strip()
        if not unit:
            continue
        if unit.startswith("("):
            # co-located: each '-'-separated member is its own logically
            # isolated instance, all sharing ONE chip
            members = [m for m in unit[1:-1].split("-") if m]
            for m in members:
                instances.append(InstanceSpec(
                    f"{m.lower()}{len(instances)}", tuple(m), chips=1,
                    coloc_group=coloc, monolithic=len(m) > 1))
            coloc += 1
            chips += 1
        else:
            # dedicated device; multi-letter unit = coupled serial stages
            instances.append(InstanceSpec(
                f"{unit.lower()}{len(instances)}", tuple(unit), chips=1,
                monolithic=len(unit) > 1))
            chips += 1
    return Deployment(name, tuple(instances), chips)


def scale(dep: Deployment, k: int) -> Deployment:
    """k replicas of a deployment (e.g. '(E-PD)x2')."""
    if k <= 1:
        return dep
    out: List[InstanceSpec] = []
    groups = max([i.coloc_group for i in dep.instances], default=-1) + 1
    for r in range(k):
        for inst in dep.instances:
            cg = inst.coloc_group + r * groups if inst.coloc_group >= 0 else -1
            out.append(replace(inst, name=f"{inst.name}_r{r}",
                               coloc_group=cg))
    return Deployment(f"{dep.name}x{k}", tuple(out), dep.n_chips * k)


# the deployments evaluated in the paper
PAPER_DEPLOYMENTS = ("TP1", "TP2", "E-PD", "(E-PD)", "EP-D", "(E-P)-D",
                     "(E-D)-P", "E-P-D")
