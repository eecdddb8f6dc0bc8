"""Convert solution HDF5 files to XDMF time series for ParaView (the
counterpart of :mod:`tdgl_tpu.visualization.convert`).

API parity with the reference ``tdgl/visualization/convert.py:11`` (which
uses ``meshio``): the XDMF XML and its heavy-data HDF5 file are written
directly, as the JAX package writes them, the heavy file through h5lite.
The XML names the same dataset paths, so ParaView and h5py read the
port's heavy file as they read the JAX package's.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..solution.data import get_data_range
from ..utils import h5lite

_XDMF_HEADER = """<?xml version="1.0"?>
<!DOCTYPE Xdmf SYSTEM "Xdmf.dtd" []>
<Xdmf Version="3.0">
  <Domain>
    <Grid Name="TimeSeries" GridType="Collection" CollectionType="Temporal">
"""

_XDMF_FOOTER = """    </Grid>
  </Domain>
</Xdmf>
"""


def convert_to_xdmf(
    input_file: str,
    output_file: Optional[str] = None,
    dimensionless: bool = False,
) -> str:
    """Write ``<name>.xdmf`` + ``<name>.xdmf.h5`` for the saved frames.

    Exports |psi|, arg(psi), mu, epsilon, and the site-averaged super/normal
    current vectors per frame.

    Returns the path of the XDMF file.
    """
    from ..solution.data import TDGLData
    from .io import load_mesh

    if output_file is None:
        output_file = os.path.splitext(input_file)[0] + ".xdmf"
    heavy_path = output_file + ".h5"
    with h5lite.File(input_file, "r") as f:
        mesh = load_mesh(f)
        scale = 1.0
        if not dimensionless and "solution/device" in f:
            scale = float(f["solution/device/layer"].attrs["coherence_length"])
        sites = np.concatenate(
            [mesh.sites * scale, np.zeros((len(mesh.sites), 1))], axis=1
        )
        elements = mesh.elements
        step_min, step_max = get_data_range(f)
        heavy_rel = os.path.basename(heavy_path)
        xml = [_XDMF_HEADER]
        with h5lite.File(heavy_path, "w") as hv:
            hv["points"] = sites
            hv["cells"] = elements
            for frame in range(step_min, step_max + 1):
                data = TDGLData.from_hdf5(f, frame)
                t = float(data.state.get("time", frame))
                grp = hv.create_group(f"frame_{frame}")
                fields = {
                    "order_parameter": np.abs(data.psi),
                    "phase": np.angle(data.psi),
                    "scalar_potential": data.mu,
                    "epsilon": data.epsilon,
                }
                vector_fields = {}
                for key, edge_vals in (
                    ("supercurrent", data.supercurrent),
                    ("normal_current", data.normal_current),
                ):
                    if edge_vals is not None:
                        v = mesh.get_quantity_on_site(edge_vals)
                        vector_fields[key] = np.concatenate(
                            [v, np.zeros((len(v), 1))], axis=1
                        )
                for key, vals in fields.items():
                    grp[key] = vals
                for key, vals in vector_fields.items():
                    grp[key] = vals
                n, m = len(sites), len(elements)
                xml.append(f"""      <Grid Name="frame_{frame}" GridType="Uniform">
        <Time Value="{t}"/>
        <Topology TopologyType="Triangle" NumberOfElements="{m}">
          <DataItem Dimensions="{m} 3" NumberType="Int" Format="HDF">{heavy_rel}:/cells</DataItem>
        </Topology>
        <Geometry GeometryType="XYZ">
          <DataItem Dimensions="{n} 3" Format="HDF">{heavy_rel}:/points</DataItem>
        </Geometry>
""")
                for key in fields:
                    xml.append(f"""        <Attribute Name="{key}" AttributeType="Scalar" Center="Node">
          <DataItem Dimensions="{n}" Format="HDF">{heavy_rel}:/frame_{frame}/{key}</DataItem>
        </Attribute>
""")
                for key in vector_fields:
                    xml.append(f"""        <Attribute Name="{key}" AttributeType="Vector" Center="Node">
          <DataItem Dimensions="{n} 3" Format="HDF">{heavy_rel}:/frame_{frame}/{key}</DataItem>
        </Attribute>
""")
                xml.append("      </Grid>\n")
        xml.append(_XDMF_FOOTER)
    with open(output_file, "w") as out:
        out.write("".join(xml))
    return output_file
