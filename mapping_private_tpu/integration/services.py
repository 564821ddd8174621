"""External-system bridges — `mapping_to_cop` / jlo, JAX-framework-native.

Replaces the ROS service plumbing the reference uses to talk to the COP
vision system and the `jlo` located-object pose registry
(mapping_to_cop/source/main.cpp:85+ JloRegisterPose; dyn_obj_store's
update_jlo at table_memory.cpp:499+ and COP calls at :605-612):

- ServiceRegistry: in-process named services (the `/intersect_poly`-style
  call sites become function calls; remote transports can be plugged in by
  registering a proxy).
- JloRegistry: the located-object database — named frames with 4×4 poses
  + 6×6 covariances in a parent-frame tree, with NAMEQUERY / FRAMEQUERY /
  UPDATE / DELETE operations matching jlo's service verbs.
- CopBridge: the object-recognition query protocol (set of object ids +
  poses in, classified names out) as an abstract interface with an
  in-process default that answers from a TableMemory.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np


class ServiceRegistry:
    """Named in-process services (the ROS service-graph analog)."""

    def __init__(self):
        self._services: Dict[str, Callable] = {}

    def register(self, name: str, fn: Callable) -> None:
        self._services[name] = fn

    def exists(self, name: str) -> bool:
        return name in self._services

    def call(self, name: str, *args, **kwargs):
        if name not in self._services:
            raise KeyError(f"service '{name}' not advertised")
        return self._services[name](*args, **kwargs)


@dataclasses.dataclass
class LocatedObject:
    """One jlo entry: id, name, parent frame, pose, covariance."""

    lo_id: int
    name: str
    parent_id: int
    pose: np.ndarray  # (4, 4)
    cov: np.ndarray  # (6, 6)


class JloRegistry:
    """The located-object pose registry (jlo's ID_WORLD = 1)."""

    ID_WORLD = 1

    def __init__(self):
        world = LocatedObject(
            lo_id=self.ID_WORLD, name="/map", parent_id=self.ID_WORLD,
            pose=np.eye(4), cov=np.zeros((6, 6)),
        )
        self._by_id: Dict[int, LocatedObject] = {self.ID_WORLD: world}
        self._by_name: Dict[str, int] = {"/map": self.ID_WORLD}
        self._next_id = 100

    def update(self, name: str, pose: np.ndarray,
               cov: Optional[np.ndarray] = None,
               parent_id: int = ID_WORLD) -> LocatedObject:
        """UPDATE verb: register or re-pose a named object
        (JloRegisterPose, main.cpp:85+)."""
        cov = np.zeros((6, 6)) if cov is None else np.asarray(cov)
        pose = np.asarray(pose, np.float64)
        if name in self._by_name:
            lo = self._by_id[self._by_name[name]]
            lo.pose = pose
            lo.cov = cov
            lo.parent_id = parent_id
            return lo
        lo = LocatedObject(self._next_id, name, parent_id, pose, cov)
        self._by_id[lo.lo_id] = lo
        self._by_name[name] = lo.lo_id
        self._next_id += 1
        return lo

    def namequery(self, name: str) -> LocatedObject:
        return self._by_id[self._by_name[name]]

    def framequery(self, lo_id: int, reference_id: int = ID_WORLD) -> np.ndarray:
        """Pose of lo_id expressed in reference_id's frame (walks the
        parent tree to world, composes)."""

        def to_world(i: int) -> np.ndarray:
            T = np.eye(4)
            seen = set()
            while i != self.ID_WORLD:
                if i in seen:
                    raise ValueError("cycle in frame tree")
                seen.add(i)
                lo = self._by_id[i]
                T = lo.pose @ T
                i = lo.parent_id
            return T

        Tw = to_world(lo_id)
        Tr = to_world(reference_id)
        return np.linalg.inv(Tr) @ Tw

    def delete(self, lo_id: int) -> None:
        lo = self._by_id.pop(lo_id)
        self._by_name.pop(lo.name, None)


class CopBridge:
    """COP-style object query: answers class names for cluster poses.

    The default implementation answers from a TableMemory belief state
    (nearest named object within match_dist); subclass / replace for a
    real vision system.
    """

    def __init__(self, table_memory=None, match_dist: float = 0.15):
        self.memory = table_memory
        self.match_dist = match_dist

    def query(self, positions: List[np.ndarray]) -> List[Optional[str]]:
        if self.memory is None:
            return [None] * len(positions)
        known = []
        for t in self.memory.tables:
            inst = t.latest()
            if inst:
                known.extend(inst.objects)
        out = []
        for p in positions:
            best, best_d = None, self.match_dist
            for o in known:
                d = float(np.linalg.norm(np.asarray(p) - o.center))
                if d < best_d:
                    best, best_d = o.name, d
            out.append(best)
        return out
