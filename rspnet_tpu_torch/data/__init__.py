"""Host-side data: catalogs, temporal transforms, decode, loader."""
