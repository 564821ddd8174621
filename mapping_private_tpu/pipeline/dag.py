"""Host-side pipeline DAG runner — the `cloud_algos` plugin layer JAX-native.

Replaces the reference's topic-wired op graphs: the `CloudAlgo` ABC with
init/pre/process/post/output and requires/provides channel contracts
(cloud_algos/include/cloud_algos/cloud_algos.h:21-44), the per-op ROS node
wrapper `CloudAlgoNode::input_cb` (:79-97), pluginlib dynamic loading
(register_plugins.cpp:19-24), and the YAML pipeline descriptions
(reconstruction_pipeline.yaml:1-28) naming {class_name, input_topic_name,
output_topics}.

Differences by design: ops run in ONE process against device arrays —
"topics" are slots in a value dict, not TCP serialization boundaries; the
whole chain stays on the device between stages.  Ops declaring jittable=True
are composed into a single traced program by `Pipeline.jitted()`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

from mapping_private_tpu.core.cloud import PointCloud

# global op registry — the pluginlib analog (PLUGINLIB_DECLARE_CLASS)
_REGISTRY: Dict[str, "OpSpec"] = {}


@dataclasses.dataclass
class OpSpec:
    """A registered op: callable (PointCloud, **params) → PointCloud or
    dict of named outputs; declares its channel contract."""

    name: str
    fn: Callable[..., Any]
    requires: Sequence[str] = ()
    provides: Sequence[str] = ()
    jittable: bool = True


def register_op(
    name: str,
    requires: Sequence[str] = (),
    provides: Sequence[str] = (),
    jittable: bool = True,
):
    """Decorator: add an op to the registry (the reference's
    PLUGINLIB_DECLARE_CLASS, register_plugins.cpp:19-24)."""

    def deco(fn):
        _REGISTRY[name] = OpSpec(
            name=name, fn=fn, requires=tuple(requires),
            provides=tuple(provides), jittable=jittable,
        )
        return fn

    return deco


def get_op(name: str) -> OpSpec:
    if name not in _REGISTRY:
        raise KeyError(f"op '{name}' not registered (have: {sorted(_REGISTRY)})")
    return _REGISTRY[name]


def registered_ops() -> List[str]:
    return sorted(_REGISTRY)


@dataclasses.dataclass
class Stage:
    """One pipeline stage (one YAML block): op + topic wiring + params."""

    op: str
    input: str
    outputs: Dict[str, str]  # op output key -> topic name ('' key = main)
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    name: Optional[str] = None


class Pipeline:
    """Executes stages in order over a dict of named values ("topics").

    Channel contracts are validated like the reference's requires() checks:
    a stage whose input PointCloud lacks a required channel raises before
    any compute runs.
    """

    def __init__(self, stages: Sequence[Stage]):
        self.stages = list(stages)

    @staticmethod
    def from_yaml(path: str) -> "Pipeline":
        """Load a reference-style pipeline YAML: a mapping of stage name →
        {class_name, input_topic_name, output_topics, params}."""
        import yaml

        with open(path) as fp:
            doc = yaml.safe_load(fp)
        stages = []
        for sname, block in doc.items():
            inp = block["input_topic_name"]
            if isinstance(inp, dict):
                inp = inp["name"]
            outs = {}
            for key, spec in (block.get("output_topics") or {}).items():
                outs[key] = spec["name"] if isinstance(spec, dict) else spec
            stages.append(
                Stage(
                    op=block["class_name"],
                    input=inp,
                    outputs=outs,
                    params=block.get("params", {}),
                    name=sname,
                )
            )
        return Pipeline(stages)

    def validate(self, values: Dict[str, Any]) -> None:
        known = set(values)
        for st in self.stages:
            spec = get_op(st.op)
            if st.input not in known:
                raise ValueError(
                    f"stage {st.name or st.op}: input topic '{st.input}' "
                    f"never produced"
                )
            known.update(st.outputs.values())

    def jitted(self):
        """Compose every stage into ONE traced program: returns a
        jax.jit-compiled fn(values dict of pytrees) → values dict.

        All stages must be registered jittable (no host-side ops); the
        whole chain then fuses under XLA — the reference's per-node
        serialize→TCP→deserialize boundaries become nothing at all."""
        import jax

        not_jittable = [st.op for st in self.stages if not get_op(st.op).jittable]
        if not_jittable:
            raise ValueError(
                f"stages not jittable: {not_jittable} — run() them instead"
            )
        return jax.jit(self.run)

    def run(self, values: Dict[str, Any]) -> Dict[str, Any]:
        """Run all stages; returns the topic dict with outputs added."""
        values = dict(values)
        self.validate(values)
        for st in self.stages:
            spec = get_op(st.op)
            inp = values[st.input]
            if isinstance(inp, PointCloud) and spec.requires:
                missing = [c for c in spec.requires if not inp.has_channel(c)]
                if missing:
                    raise ValueError(
                        f"stage {st.name or st.op}: input lacks required "
                        f"channels {missing} (the reference's requires() "
                        f"contract)"
                    )
            out = spec.fn(inp, **st.params)
            if isinstance(out, dict):
                for key, topic in st.outputs.items():
                    if key not in out:
                        raise KeyError(
                            f"stage {st.name or st.op}: op returned no '{key}'"
                        )
                    values[topic] = out[key]
            else:
                # single-output op: wire to every declared output topic
                for topic in st.outputs.values():
                    values[topic] = out
        return values


# ---------------------------------------------------------------------------
# built-in op registrations (the reference's register_plugins.cpp set +
# the pcl_cloud_algos ops the table memory depends on)
# ---------------------------------------------------------------------------


def _register_builtins() -> None:
    import jax
    import jax.numpy as jnp

    from mapping_private_tpu.ops.filters import remove_statistical_outliers
    from mapping_private_tpu.ops.mls import mls
    from mapping_private_tpu.ops.normals import estimate_normals
    from mapping_private_tpu.ops.voxel import voxel_downsample
    from mapping_private_tpu.fit.cylinder import fit_cylinder_ransac
    from mapping_private_tpu.fit.box import fit_box_zup
    from mapping_private_tpu.fit.rotational import fit_rotational_ransac

    @register_op("StatisticalNoiseRemoval")
    def _noise(cloud: PointCloud, k: int = 30, alpha: float = 1.0,
               min_nr_pts: int = 0):
        out, valid = remove_statistical_outliers(
            cloud, k=k, alpha=alpha, min_nr_pts=min_nr_pts
        )
        return {"cloud": out, "valid": valid}

    @register_op("MovingLeastSquares")
    def _mls(cloud: PointCloud, search_radius: float = 0.03, k: int = 32):
        return {"cluster": mls(cloud, search_radius=search_radius, k=k)}

    @register_op("NormalEstimation")
    def _normals(cloud: PointCloud, k: int = 20):
        return {"cloud": estimate_normals(cloud, k=k)}

    @register_op("VoxelDownsample")
    def _down(cloud: PointCloud, leaf_size: float = 0.02,
              capacity: int = 4096, key=None):
        key = jax.random.PRNGKey(0) if key is None else key
        return {"cloud": voxel_downsample(cloud, leaf_size, capacity)}

    @register_op("CylinderEstimation", requires=("normal",))
    def _cyl(cloud: PointCloud, threshold: float = 0.01, seed: int = 0):
        cyl, inl = fit_cylinder_ransac(
            cloud.padded_xyz(), cloud.channel("normal"), cloud.mask,
            jax.random.PRNGKey(seed), threshold=threshold,
        )
        return {"model": cyl, "inliers": cloud.select(inl),
                "outliers": cloud.select(~inl)}

    @register_op("RobustBoxEstimation")
    def _box(cloud: PointCloud):
        return {"model": fit_box_zup(cloud.padded_xyz(), cloud.mask)}

    @register_op("RotationalEstimation", requires=("normal",))
    def _rot(cloud: PointCloud, threshold: float = 0.01, seed: int = 0):
        surf, inl = fit_rotational_ransac(
            cloud.padded_xyz(), cloud.channel("normal"), cloud.mask,
            jax.random.PRNGKey(seed), threshold=threshold,
        )
        return {"model": surf, "inliers": cloud.select(inl),
                "outliers": cloud.select(~inl)}

    @register_op("DepthImageTriangulation", jittable=False)
    def _tri(organized, max_edge: float = 0.05):
        """organized: dict with 'points' (H,W,3) and 'valid' (H,W)."""
        from mapping_private_tpu.ops.triangulation import (
            compact_mesh, triangulate_depth_image,
        )
        import numpy as _np

        tris, ok = triangulate_depth_image(
            organized["points"], organized["valid"], max_edge=max_edge
        )
        verts, t = compact_mesh(
            _np.asarray(organized["points"]), _np.asarray(tris), _np.asarray(ok)
        )
        return {"mesh": (verts, t)}


_register_builtins()
