"""Analysis layer of the port: the whole-slide sweep, the CERAD statistics
and the speed check (:mod:`.validation`), the prospective study
(:mod:`.prospective`), its figures (:mod:`.plots`) and the checks of the
study data (:mod:`.data_checks`)."""

from . import plots, prospective, validation  # noqa: F401
