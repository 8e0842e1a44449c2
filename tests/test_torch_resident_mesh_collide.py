"""The port's mesh_resident_pipeline on the collision vocabulary (12
tokens in one vhash8 bucket, random ASCII tokens: many misses, spliced
on the host): at D = 2 and D = 1 equal to each other and to the host
engine in all four configurations, and equal to the JAX package's at
get_mesh(2) (interpret mode), all 11 outputs, for "ascii+hot" and
"general" (tests/torch_resident_mesh_util.py)."""

import pytest

import torch_resident_mesh_util as U
from torch_port_util import collision_vocab

JAX_CONFIGS = ("ascii+hot", "general")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    ranks = collision_vocab()[0]
    cfgs = U.configs(ranks, seed=5, check_jax=True)
    return ranks, cfgs, U.spawn_d2(ranks, cfgs,
                                   tmp_path_factory.mktemp("mesh2c"))


@pytest.mark.parametrize("name", U.CONFIGS)
def test_mesh_pipeline_d2_equals_d1_and_host(case, name):
    ranks, cfgs, d2 = case
    U.assert_equal(d2[name], U.port_d1(ranks, cfgs[name]))
    U.assert_host(ranks, cfgs[name], d2[name])


@pytest.mark.parametrize("name", JAX_CONFIGS)
def test_mesh_pipeline_equals_jax(case, name):
    ranks, cfgs, d2 = case
    U.assert_equal(d2[name], U.jax_outputs(ranks, cfgs[name]))
