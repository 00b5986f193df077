"""The port's command line against the JAX package's, parser by parser: the
option strings (and positional arguments) of each build_*_parser pair must
be the same, but for the documented deviations (ROADMAP, "CLI flags"):
--device stands in for --platform on every parser that has it, and follow
also takes the observability flag --metrics-out. No flag of the JAX
package may be missing from the port.
"""

import pytest

import tpusim.cli as jax_cli

import tpusim_torch.cli as port_cli

PARSERS = ("build_parser", "build_serve_parser", "build_stream_parser",
           "build_follow_parser", "build_promote_parser",
           "build_audit_parser", "build_explain_parser", "build_top_parser")
# parser -> (flags of the JAX parser the port replaces, flags only the
# port has)
DEVIATIONS = {
    "build_follow_parser": ({"--platform"}, {"--device", "--metrics-out"}),
    "build_explain_parser": (set(), set()),
    "build_top_parser": (set(), set()),
}
DEVICE_FOR_PLATFORM = ({"--platform"}, {"--device"})


def surface(parser) -> set:
    return ({o for a in parser._actions for o in a.option_strings}
            | {a.dest for a in parser._actions if not a.option_strings})


def test_every_parser_pair_is_compared():
    assert set(PARSERS) == {n for n in dir(jax_cli)
                            if n.startswith("build_")
                            and n.endswith("_parser")}


@pytest.mark.parametrize("name", PARSERS)
def test_parser_surfaces_match(name):
    jax = surface(getattr(jax_cli, name)())
    port = surface(getattr(port_cli, name)())
    replaced, added = DEVIATIONS.get(name, DEVICE_FOR_PLATFORM)
    assert jax - port == replaced, f"{name}: JAX flags missing from the port"
    assert port - jax == added, f"{name}: port flags the JAX CLI lacks"


@pytest.mark.parametrize("name", ["build_parser", "build_serve_parser"])
def test_mesh_flag_on_both(name):
    assert "--mesh" in surface(getattr(port_cli, name)())
