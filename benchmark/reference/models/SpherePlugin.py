"""SpherePlugin, the user's model file ``benchmark/plugins/SpherePlugin.py``:
its form factor, volume, absolute volume and defaults are upstream's
Sphere's, so this module is the plain Sphere reference (``Sphere.py``)
under the plugin's name."""
from .Sphere import DEFAULTS, absvolume, engine_params, ff, volume

__all__ = ["DEFAULTS", "ff", "volume", "absvolume", "engine_params"]
