"""The port's precision policies against the JAX package's.

``repro_torch/core/precision.py`` is a plain copy of the reference: the
op classes, every preset's rules and formats, ``policy_for`` and
``validate`` must be the reference's (twin of
``tests/test_roofline_tools.py``'s precision tests).
"""
import dataclasses

import pytest

from repro.core import precision as jpp
from repro_torch.core import precision as tpp

from torch_train_parity import one_torch_thread  # noqa: F401 (a fixture)


def test_presets_equal_the_reference():
    assert tpp.OP_CLASSES == jpp.OP_CLASSES
    assert sorted(tpp.POLICIES) == sorted(jpp.POLICIES)
    for name, pol in tpp.POLICIES.items():
        assert dataclasses.asdict(pol) == dataclasses.asdict(
            jpp.POLICIES[name])
        assert pol.uses_fp8() == jpp.POLICIES[name].uses_fp8()
        for op in tpp.OP_CLASSES:
            assert pol.dtype_for(op) == jpp.POLICIES[name].dtype_for(op)


def test_policies_validate():
    for p in tpp.POLICIES.values():
        tpp.validate(p)


def test_fp8_policy_keeps_sensitive_ops_high():
    p = tpp.FP8_TRAINING
    assert p.uses_fp8()
    assert p.dtype_for("router") == "f32"
    assert p.dtype_for("ssm_recurrence") == "f32"
    assert p.dtype_for("mlp") == "fp8"


@pytest.mark.parametrize("precision", ["fp8", "bf16", "f32"])
@pytest.mark.parametrize("serving", [False, True])
def test_policy_resolution_matches_the_reference(precision, serving):
    assert tpp.policy_for(precision, serving=serving).name == \
        jpp.policy_for(precision, serving=serving).name
    assert tpp.policy_for("fp8").name == "fp8_training"
    assert tpp.policy_for("fp8", serving=True).name == "fp8_serving"
    assert tpp.policy_for("bf16").name == "bf16_baseline"


@pytest.mark.parametrize("op,value,grad", [
    ("router", "fp8", "e5m2"), ("norm", "fp8", "e5m2"),
    ("ssm_recurrence", "fp8", "e5m2"), ("mlp", "fp8", "e4m3"),
    ("mlp", "fp8", "bf16")])
def test_validate_rejects_as_the_reference(op, value, grad):
    def outcome(pp):
        bad = pp.PrecisionPolicy("bad", {**pp.BF16_BASELINE.rules,
                                         op: value}, grad_dtype=grad)
        try:
            pp.validate(bad)
        except ValueError as e:
            return str(e)
        return None
    got = outcome(tpp)
    assert got == outcome(jpp)
    if op in ("router", "norm", "ssm_recurrence"):
        assert "must not run in FP8" in got
    elif grad == "e4m3":
        assert "range-wide" in got
    else:
        assert got is None


def test_unknown_op_class_raises():
    with pytest.raises(KeyError):
        tpp.BF16_BASELINE.dtype_for("nonexistent")
