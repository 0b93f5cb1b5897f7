"""Analysis layer of the port: the whole-slide sweep
(:mod:`.validation`).  The plots, the prospective study, the data checks
and the CERAD statistics are not ported yet (ROADMAP.md)."""

from . import validation  # noqa: F401
