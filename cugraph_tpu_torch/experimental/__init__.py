"""Experimental namespace (ref: python/cugraph/cugraph/experimental/)."""

from . import compat_nx
from .datasets import Dataset, karate, dolphins, email_eu_core, netscience
