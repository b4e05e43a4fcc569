"""cmfrec_torch's public classes against cmfrec_tpu's, by signature.

Every public method of cmfrec_tpu's seven model classes, and every
argument of each, exists in cmfrec_torch's class of the same name (the
port may add arguments, such as ``device``).  A class the port did not
have yet would sit in WAIVED with the ROADMAP slice that brings it; since
slice 6 there is none.
"""

import inspect

import pytest

import cmfrec_torch
import cmfrec_tpu

CLASSES = ["CMF", "CMF_implicit", "CMF_imputer", "OMF_explicit",
           "OMF_implicit", "ContentBased", "MostPopular"]
WAIVED = {}


def _public_methods(cls):
    return {name: fn for name, fn in inspect.getmembers(cls, callable)
            if not name.startswith("_") or name == "__init__"}


def _missing(cname):
    ours = getattr(cmfrec_torch, cname)
    missing = []
    for name, ref in _public_methods(getattr(cmfrec_tpu, cname)).items():
        target = getattr(ours, name, None)
        if target is None:
            missing.append(f"{cname}.{name} (method absent)")
            continue
        params = inspect.signature(target).parameters
        if any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in params.values()):
            continue
        missing += [f"{cname}.{name}(..., {arg})"
                    for arg in inspect.signature(ref).parameters
                    if arg not in params]
    return missing


@pytest.mark.parametrize("cname", CLASSES)
def test_port_is_a_superset_of_cmfrec_tpu(cname):
    missing = _missing(cname)
    assert not missing, "cmfrec_tpu API absent from the port:\n" + "\n".join(
        missing)


def test_the_waiver_lists_exactly_the_missing_classes():
    """cmfrec_tpu's public model classes (tests/test_api_superset.py's
    list) are the checked ones and the waived ones, and only the waived
    ones are absent from the port."""
    from tests.test_api_superset import PUBLIC_CLASSES

    assert sorted(CLASSES + list(WAIVED)) == sorted(PUBLIC_CLASSES)
    assert all(inspect.isclass(getattr(cmfrec_tpu, name))
               for name in PUBLIC_CLASSES)
    absent = {name for name in PUBLIC_CLASSES
              if not hasattr(cmfrec_torch, name)}
    assert absent == set(WAIVED), absent ^ set(WAIVED)
