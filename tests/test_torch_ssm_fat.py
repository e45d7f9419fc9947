"""Fault-aware training of the SSM and hybrid families (reduced
falcon-mamba-7b and hymba-1.5b) in the port against the reference's
``LMFATTrainer``, on the CPU, through every engine: the harness of
``tests/test_torch_moe_fat.py`` (the reference's batches and initial params,
24 x 40 maps, the same tolerances and checks).

The selective scan's plain version runs under ``vmap`` of
``grad_and_value`` in the population engines. ``sharded-tp``
(``compute="sharded"``) runs falcon-mamba on 2 x 2, where ``in_proj``'s two
pieces are its x and z halves and every ``"inner"`` leaf splits at channel
64, and hymba on 2 x 4: ``in_proj``'s pieces start at 64, 128 and 192,
``x_proj``'s rows at 32, 64 and 96, and the block runs one scan a channel
piece beside its attention.
"""
import pytest

from test_torch_moe_fat import (  # noqa: F401  (_one_torch_thread: the module's autouse fixture)
    ENGINES,
    METRIC_TOL,
    _one_torch_thread,
    check_steps_and_table,
    check_train_and_evaluate,
    port_trainer,
    reference_results,
)

ARCHS = ["falcon-mamba-7b", "hymba-1.5b"]


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    return request.param, reference_results(request.param)


@pytest.fixture(scope="module", params=ENGINES)
def port(request, ref):
    return port_trainer(ref[0], request.param)


def test_pretrained_trainer_matches_reference(ref, port):
    jtr = ref[1]["trainer"]
    assert port.baseline_metric == pytest.approx(jtr.baseline_metric, abs=METRIC_TOL)


def test_steps_to_constraint_and_table_match_reference(ref, port):
    check_steps_and_table(ref[0], ref[1], port)


def test_train_and_evaluate_batch_match_reference(ref, port):
    check_train_and_evaluate(ref[0], ref[1], port)
