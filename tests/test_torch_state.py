"""PyTorch port: filter state and the numpy state carrier vs the JAX package.

Both packages run on the CPU; the port is asked for ``device="cpu"``
explicitly. Tolerance: exact — init_state is built from the same numpy
arithmetic in both packages, so every field must be bit-identical.
"""

import numpy as np
import pytest
import torch

from cv_monoslam_tpu.config import SlamConfig as JaxConfig
from cv_monoslam_tpu.filter import state as jstate
from cv_monoslam_tpu_torch.config import SlamConfig
from cv_monoslam_tpu_torch.convert import state_from_arrays, state_to_arrays
from cv_monoslam_tpu_torch.filter import state as tstate


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_init_state_matches_jax_field_for_field(dtype):
    kw = dict(max_landmarks=5, hp_init=4, hp_match=3, dtype=dtype)
    want = state_to_arrays(jstate.init_state(JaxConfig(**kw), theta0=0.3,
                                             max_stored=7))
    got = state_to_arrays(tstate.init_state(SlamConfig(**kw), theta0=0.3,
                                            max_stored=7, device="cpu"))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_state_round_trip_through_arrays():
    rng = np.random.default_rng(0)
    cfg = SlamConfig(max_landmarks=3, dtype="float64")
    arrays = state_to_arrays(tstate.init_state(cfg, device="cpu"))
    for k, v in arrays.items():          # non-trivial contents everywhere
        if v.dtype == bool:
            arrays[k] = rng.random(v.shape) < 0.5
        elif np.issubdtype(v.dtype, np.integer):
            arrays[k] = rng.integers(0, 100, v.shape).astype(v.dtype)
        else:
            arrays[k] = rng.normal(size=v.shape).astype(v.dtype)
    back = state_to_arrays(state_from_arrays(arrays, device="cpu"))
    assert set(back) == set(arrays)
    for k in arrays:
        assert back[k].dtype == arrays[k].dtype, k
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)


def test_state_from_arrays_rejects_unknown_and_missing_fields():
    arrays = state_to_arrays(tstate.init_state(SlamConfig(max_landmarks=2),
                                               device="cpu"))
    with pytest.raises(KeyError):
        state_from_arrays({**arrays, "lm.bogus": np.zeros(2)}, device="cpu")
    arrays.pop("stored.sr")
    with pytest.raises(KeyError):
        state_from_arrays(arrays, device="cpu")


def test_init_state_without_device_raises_on_cpu_only_host():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstate.init_state(SlamConfig(max_landmarks=2))


@pytest.mark.parametrize("levels,minor,major", [
    ((0,), 0, 0), ((1, 3), 2, 0), ((4, 2, 0), 1, 1)])
def test_count_repairs_matches_jax(levels, minor, major):
    cfg = SlamConfig(max_landmarks=2)
    st = tstate.count_repairs(tstate.init_state(cfg, device="cpu"),
                              *[torch.tensor(lv) for lv in levels])
    js = jstate.count_repairs(jstate.init_state(JaxConfig(max_landmarks=2)),
                              *[np.int32(lv) for lv in levels])
    assert int(st.n_repairs) == int(js.n_repairs) == minor
    assert int(st.n_escalations) == int(js.n_escalations) == major
