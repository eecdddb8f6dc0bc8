"""Superconducting layer (material) parameters.

API parity with the reference ``tdgl/device/layer.py:6-128``.
"""

from __future__ import annotations

from typing import Optional



class Layer:
    """Material parameters of a superconducting thin film.

    Args:
        london_lambda: London penetration depth :math:`\\lambda`.
        coherence_length: Ginzburg-Landau coherence length :math:`\\xi`.
        thickness: Film thickness :math:`d`.
        conductivity: Normal-state conductivity :math:`\\sigma`
            in Siemens / length_unit.
        u: Ratio of relaxation times for the order parameter amplitude and
            phase (5.79 for dirty superconductors).
        gamma: Strength of inelastic phonon-electron scattering,
            :math:`\\gamma`.
        z0: Vertical position of the film.
    """

    def __init__(
        self,
        *,
        london_lambda: float,
        coherence_length: float,
        thickness: float,
        conductivity: Optional[float] = None,
        u: float = 5.79,
        gamma: float = 10.0,
        z0: float = 0.0,
    ):
        self.london_lambda = london_lambda
        self.coherence_length = coherence_length
        self.thickness = thickness
        self.conductivity = conductivity
        self.u = u
        self.gamma = gamma
        self.z0 = z0

    @property
    def Lambda(self) -> float:
        """Effective magnetic penetration depth :math:`\\Lambda=\\lambda^2/d`."""
        return self.london_lambda**2 / self.thickness

    def copy(self) -> "Layer":
        """Return a deep copy."""
        return Layer(
            london_lambda=self.london_lambda,
            coherence_length=self.coherence_length,
            thickness=self.thickness,
            conductivity=self.conductivity,
            u=self.u,
            gamma=self.gamma,
            z0=self.z0,
        )

    _FIELDS = ("london_lambda", "coherence_length", "thickness", "conductivity",
               "u", "gamma", "z0")

    def to_hdf5(self, h5_group: h5py.Group) -> None:
        """Save to an HDF5 group."""
        for field in self._FIELDS:
            value = getattr(self, field)
            if value is not None:
                h5_group.attrs[field] = value

    @staticmethod
    def from_hdf5(h5_group: h5py.Group) -> "Layer":
        """Load from an HDF5 group."""
        kwargs = {f: h5_group.attrs.get(f) for f in Layer._FIELDS}
        return Layer(**kwargs)

    def __eq__(self, other) -> bool:
        if self is other:
            return True
        if not isinstance(other, Layer):
            return False
        return all(getattr(self, f) == getattr(other, f) for f in self._FIELDS)

    def __repr__(self) -> str:
        args = ", ".join(f"{f}={getattr(self, f)!r}" for f in self._FIELDS)
        return f"Layer({args})"
