"""The readers of the noisy cell's stage parts on made-up records: the
window's mean of their stats key, and None where the program does not
record it (a commit before the key)."""
import pytest

import helpers  # noqa: F401  (puts the checkout on sys.path)
from benchmark import run

READERS = {"diffusion_plan_s": "t_diffusion_plan", "refine_s": "t_refine"}


def read(name, stats):
    return run.metric_reader(name).read(dict(stats=stats))


@pytest.mark.parametrize("name,key", sorted(READERS.items()))
def test_the_mean_of_the_window(name, key):
    st = [{key: 0.25, "t_fit": 1.0}, {key: 0.75, "t_fit": 1.0}]
    assert read(name, st) == pytest.approx(0.5)
    # a model where the stage did not run reads 0 and counts
    assert read(name, st + [{key: 0.0}]) == pytest.approx(1.0 / 3)


@pytest.mark.parametrize("name,key", sorted(READERS.items()))
def test_none_without_the_key(name, key):
    assert read(name, []) is None
    assert read(name, [{"t_fit": 1.0}]) is None
    assert read(name, [{key: 0.5}, {"t_fit": 1.0}]) is None
