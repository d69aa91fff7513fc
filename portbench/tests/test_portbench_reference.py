"""The reference agrees with the program's CPU routes, row for row, at a
small batch of each configuration, and the control (int4 weights) does
not."""
import numpy as np
import pytest
import torch

from portbench import control, model as M, port
from portbench.harness import HERE, load_json
from portbench.reference import int8_cnn as R


def setup(name, seed, rows):
    config = load_json(HERE / "configs" / f"{name}.json")
    qmodel = M.make_model(config, seed, "cpu")
    xs = M.make_frames(config, qmodel, seed, rows, "cpu")
    return config, qmodel, xs


@pytest.mark.parametrize("name", ["person", "speech"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_reference_equals_program_on_cpu(name, use_kernels):
    config, qmodel, xs = setup(name, 2**33 + 17, 12)
    ref = R.forward_int8(qmodel, xs, block=5).numpy()
    from repro_torch.core import CompiledModel
    cm = CompiledModel(port.to_graph(qmodel), use_kernels=use_kernels,
                       device="cpu")
    got = cm.predict_q_many(xs.numpy()[:, None], max_batch=4)
    np.testing.assert_array_equal(got.reshape(ref.shape), ref)
    # the answers tell the rows apart, so a row sent back to the wrong
    # request is seen
    assert len({tuple(r) for r in ref}) >= 8


@pytest.mark.parametrize("name", ["person", "speech"])
def test_same_seed_same_model_and_rows(name):
    a = setup(name, 5, 4)
    b = setup(name, 5, 4)
    c = setup(name, 6, 4)
    assert torch.equal(a[2], b[2]) and not torch.equal(a[2], c[2])
    for la, lb in zip(a[1]["layers"], b[1]["layers"]):
        if "w" in la:
            np.testing.assert_array_equal(la["w"], lb["w"])


@pytest.mark.parametrize("name", ["person", "speech"])
def test_int4_control_fails_the_limit(name):
    config, qmodel, xs = setup(name, 31, 16)
    ref = R.forward_int8(qmodel, xs).numpy().astype(int)
    ctl = R.forward_int8(control.int4_model(qmodel), xs).numpy().astype(int)
    assert np.abs(ctl - ref).max() > config["limits"]["max_gap_lsb"]
