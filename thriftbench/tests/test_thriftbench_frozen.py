"""The yardstick reads what it read before its block and kernel files came
apart (``frozen.py``): for every arm of the tiny copy and of the real pools
the same spec lists, FLOP counts and kernel bounds, and at tiny sizes on the
CPU, on pinned instruction-set paths, the same drawn layouts and reference
logits, bit for bit. Only the arms ``frozen.json`` names are held: an arm a
later pool file adds is read by nothing here."""
import json
from pathlib import Path

import pytest

from thriftbench.tests import frozen

FROZEN = json.loads((Path(__file__).resolve().parent / "frozen.json").read_text())
TINY = sorted(label for label, v in FROZEN.items() if "draws" in v)


@pytest.fixture(scope="module")
def arms():
    return dict(frozen.arms())


def test_every_arm_is_frozen(arms):
    """Every arm frozen is still run."""
    assert set(FROZEN) <= set(arms)


@pytest.mark.parametrize("label", sorted(FROZEN))
def test_shapes_equal_the_frozen(arms, label):
    got = json.loads(json.dumps(frozen.shapes(arms[label])))       # tuples as lists
    assert got == FROZEN[label]["shapes"]


@pytest.fixture(scope="module")
def pinned(tmp_path_factory):
    return frozen.pinned(tmp_path_factory.mktemp("frozen") / "readings.json", sorted(FROZEN))


def test_pinned_shapes_equal_the_frozen(pinned):
    assert {k: pinned[k]["shapes"] for k in FROZEN} == {k: v["shapes"] for k, v in FROZEN.items()}


@pytest.mark.parametrize("label", TINY)
def test_drawn_layouts_equal_the_frozen(pinned, label):
    assert pinned[label]["draws"] == FROZEN[label]["draws"]


@pytest.mark.parametrize("label", TINY)
def test_reference_logits_equal_the_frozen(pinned, label):
    assert pinned[label]["logits"] == FROZEN[label]["logits"]
