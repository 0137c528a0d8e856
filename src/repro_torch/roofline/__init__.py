from . import analytic, hlo
