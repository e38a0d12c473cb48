"""The benchmark's frozen conical reference (benchmark/reference/conical.py)
held to the port's conical render (spacetime_tpu_torch.ops.curved) on the
CPU: the cases of benchmark/tests/test_conical_reference.py, collected here
as well so that the tier-1 command, which runs tests/ only, fails when
ops/curved.py drifts from that reference.  Stage by stage and for the whole
frame (one defect and two, opaque and not, two seeds), the defect mattering
in that scene, and a configuration naming one defect or several."""

from benchmark.tests.test_conical_reference import (  # noqa: F401
    test_a_configuration_names_one_defect_or_several,
    test_the_conical_reference_agrees_with_the_port_stage_by_stage,
    test_the_defect_matters_in_that_scene,
)
