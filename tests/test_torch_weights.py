"""Port weight import and BN folding against the JAX package."""

import numpy as np
import pytest
import torch

from amyloid_yolo_tpu.io import weights as jax_weights
from amyloid_yolo_tpu.models import darknet as jax_darknet
from amyloid_yolo_tpu_torch.graphspec import yolov3_spec
from amyloid_yolo_tpu_torch.io import weights as port_weights
from amyloid_yolo_tpu_torch.models import darknet as port_darknet

from minispec import mini_spec
from torch_port_helpers import jax_params_np, port_mini_spec


@pytest.fixture(scope="module")
def mini():
    return port_mini_spec(), mini_spec(), jax_params_np(mini_spec(), 5, bn_noise=True)


def _assert_sd_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_params_from_jax_equals_reference_state_dict(mini):
    port_spec, ref_spec, params = mini
    sd = port_weights.params_from_jax(params, port_spec)
    ref = jax_weights.params_to_torch_state_dict(ref_spec, params)
    _assert_sd_equal({k: v.numpy() for k, v in sd.items()}, ref)
    assert sd["module_list.0.conv_0.weight"].shape == (4, 3, 3, 3)  # OIHW


def test_params_round_trip(mini):
    port_spec, _, params = mini
    back = port_weights.params_to_jax(port_weights.params_from_jax(params, port_spec),
                                      port_spec)
    assert sorted(back) == sorted(params)
    for k, v in params.items():
        assert sorted(back[k]) == sorted(v)
        for leaf in v:
            np.testing.assert_array_equal(back[k][leaf], v[leaf], err_msg=f"{k}.{leaf}")


def test_fold_batchnorm_bit_identical(mini):
    port_spec, ref_spec, params = mini
    port = port_darknet.fold_batchnorm(port_weights.params_from_jax(params, port_spec),
                                       port_spec)
    ref = jax_darknet.fold_batchnorm(params, ref_spec)
    assert sorted(port) == sorted(ref)
    for k in ref:
        # f32, same operations: bit-identical (OIHW vs HWIO layout)
        np.testing.assert_array_equal(
            port[k]["w"].numpy(), np.asarray(ref[k]["w"]).transpose(3, 2, 0, 1), err_msg=k)
        np.testing.assert_array_equal(port[k]["b"].numpy(), np.asarray(ref[k]["b"]),
                                      err_msg=k)


def test_darknet_binary_load_matches(mini, tmp_path):
    port_spec, ref_spec, params = mini
    path = str(tmp_path / "mini.weights")
    jax_weights.save_darknet_weights(ref_spec, params, path, seen=123)
    ref_params, ref_header = jax_weights.load_darknet_weights(ref_spec, path)
    sd, header = port_weights.load_darknet_weights(port_spec, path)
    np.testing.assert_array_equal(header, np.asarray(ref_header))
    assert header[3] == 123
    ref_sd = port_weights.params_from_jax(jax_params_to_np(ref_params), port_spec)
    _assert_sd_equal({k: v.numpy() for k, v in sd.items()},
                     {k: v.numpy() for k, v in ref_sd.items()})


def test_darknet_binary_size_mismatch_raises(mini, tmp_path):
    port_spec, ref_spec, params = mini
    path = str(tmp_path / "short.weights")
    jax_weights.save_darknet_weights(ref_spec, params, path)
    with open(path, "ab") as fh:
        np.zeros(3, np.float32).tofile(fh)
    with pytest.raises(ValueError, match="size mismatch"):
        port_weights.load_darknet_weights(port_spec, path)


def test_torch_state_dict_load_matches(mini, tmp_path):
    port_spec, ref_spec, params = mini
    ref = jax_weights.params_to_torch_state_dict(ref_spec, params)
    path = str(tmp_path / "ckpt.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in ref.items()}, path)
    sd = port_weights.load_torch_state_dict(port_spec, path)
    want = {k: v for k, v in ref.items() if not k.endswith("num_batches_tracked")}
    _assert_sd_equal({k: v.numpy() for k, v in sd.items()}, want)
    ref_params = jax_weights.load_torch_state_dict(ref_spec, path)
    _assert_sd_equal(
        {k: v.numpy() for k, v in port_weights.params_from_jax(
            jax_params_to_np(ref_params), port_spec).items()
         if not k.endswith("num_batches_tracked")},
        {k: v.numpy() for k, v in sd.items()})


def test_init_params_reference_scheme(mini):
    port_spec, ref_spec, params = mini
    sd = port_darknet.init_params(torch.Generator().manual_seed(0), port_spec)
    ref = jax_weights.params_to_torch_state_dict(ref_spec, params)
    assert sorted(sd) == sorted(ref)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(np.shape(ref[k])), k
    big = port_darknet.init_params(torch.Generator().manual_seed(0), yolov3_spec())
    w = big["module_list.73.conv_73.weight"]
    assert abs(w.mean().item()) < 1e-3 and abs(w.std().item() - 0.02) < 1e-3
    g = big["module_list.73.batch_norm_73.weight"]
    assert abs(g.mean().item() - 1) < 5e-3 and abs(g.std().item() - 0.02) < 5e-3
    assert torch.all(big["module_list.73.batch_norm_73.running_var"] == 1)
    assert torch.all(big["module_list.105.conv_105.bias"] == 0)


def jax_params_to_np(params):
    return {k: {leaf: np.asarray(v) for leaf, v in d.items()} for k, d in params.items()}
