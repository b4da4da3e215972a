"""Legacy location of the straggler controller (paper App. B.1), as in JAX:
:class:`repro_torch.api.StragglerController` re-exported."""
from repro_torch.api.schedule import StragglerController  # noqa: F401
