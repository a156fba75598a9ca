"""Host IO: shot readers, HDF5 store, SPEC binaries, native prefetcher (the
counterpart of ``specenh.io``).  h5py is imported only where a file is
opened."""

from specenh_torch.io.shots import (  # noqa: F401
    ShotReadError,
    bes_key,
    ece_key,
    read_bes_channels,
    read_ece_channels,
    shot_number_from_path,
)
from specenh_torch.io.store import (  # noqa: F401
    CampaignManifest,
    SpectrogramStore,
    StoreWriterPool,
    consolidate_shards,
)
