"""Spec-dict CLI generator (reference utils.py:7-53 semantics)."""

import pytest

from bert4clickpath.utils.cli import parse_spec_args


def test_defaults_and_overrides():
    spec = {"lr": 1e-3, "steps": 100, "name": "run"}
    out = parse_spec_args(spec, [])
    assert out == {"lr": 1e-3, "steps": 100, "name": "run"}
    out = parse_spec_args(spec, ["--lr", "0.01", "--steps", "5"])
    assert out["lr"] == 0.01 and out["steps"] == 5


def test_required_type_spec():
    spec = {"gamma": float}
    with pytest.raises(SystemExit):
        parse_spec_args(spec, [])
    assert parse_spec_args(spec, ["--gamma", "2.5"])["gamma"] == 2.5


def test_bool_single_hyphen_switch():
    # booleans use single-hyphen store_true/false (reference utils.py:44-46)
    spec = {"silent": True, "verbose": False}
    out = parse_spec_args(spec, [])
    assert out == {"silent": False, "verbose": True}  # argparse store_x defaults
    out = parse_spec_args(spec, ["-silent", "-verbose"])
    assert out == {"silent": True, "verbose": False}


def test_none_spec_accepts_string():
    assert parse_spec_args({"ckpt": None}, [])["ckpt"] is None
    assert parse_spec_args({"ckpt": None}, ["--ckpt", "/x"])["ckpt"] == "/x"
