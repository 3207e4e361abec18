"""rustsasa_jax — an accelerator-native Shrake-Rupley SASA framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of RustSASA
(maxall41/RustSASA): absolute solvent-accessible surface area per atom of a
protein structure, aggregated to residue/chain/protein level, with a builder
API, a CLI (single file + directory batch), JSON/XML/PDB/CIF output, custom
radii configs, and an MD-trajectory streaming path — engineered for GPU
devices instead of CPU threads.
"""

from .api import SASAOptions
from .constants import (
    DEFAULT_N_POINTS,
    DEFAULT_PROBE_RADIUS,
    POLAR_AMINO_ACIDS,
)
from .io.read import StructureReadError, parse_structure, read_structure
from .io.serialize import (
    sasa_result_to_bfactors,
    sasa_result_to_json,
    sasa_result_to_xml,
)
from .io.structure import Structure
from .levels import (
    ChainResult,
    Level,
    ProteinResult,
    ResidueResult,
    SASAResult,
    serialize_chain_id,
)
from .ops.engine import BatchedSasaEngine, SasaParams, calculate_sasa_internal
from .utils.jax_cache import enable_persistent_cache
from .radii import (
    RadiusMissingError,
    VanDerWaalsMissingError,
    get_protor_radius,
    get_radius,
    get_vdw_radius,
    load_radii_from_file,
    parse_radii_config,
)

__version__ = "0.1.0"

__all__ = [
    "SASAOptions",
    "Level",
    "SASAResult",
    "ResidueResult",
    "ChainResult",
    "ProteinResult",
    "Structure",
    "StructureReadError",
    "read_structure",
    "parse_structure",
    "serialize_chain_id",
    "sasa_result_to_json",
    "sasa_result_to_xml",
    "sasa_result_to_bfactors",
    "BatchedSasaEngine",
    "SasaParams",
    "calculate_sasa_internal",
    "DEFAULT_N_POINTS",
    "DEFAULT_PROBE_RADIUS",
    "POLAR_AMINO_ACIDS",
    "RadiusMissingError",
    "VanDerWaalsMissingError",
    "get_protor_radius",
    "get_radius",
    "get_vdw_radius",
    "load_radii_from_file",
    "parse_radii_config",
    "enable_persistent_cache",
    "__version__",
]
