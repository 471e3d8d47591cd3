"""The two routes of the port's data layer, for its Pillow-parity tests.

`route` runs a test once through the host library (fourdgs_tpu_torch's
csrc/host, C++) and once through the plain versions beside each caller
(numpy and Python), swapped in for the test's length by
chip_smoke.plain_host_route, which phase 18 uses on the card. Import it
into a test module (`from tests._torch_routes import route`) and take it
as an argument.
"""
import pytest

import chip_smoke


@pytest.fixture(params=["native", "plain"])
def route(request):
    if request.param == "native":
        yield request.param
    else:
        with chip_smoke.plain_host_route():
            yield request.param
