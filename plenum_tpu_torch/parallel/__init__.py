"""Multi-device planes. Nothing is imported until it is used: the names
below resolve on first access, so importing a submodule (or this
package) loads neither the crypto plane nor its kernels' modules."""

__all__ = ["make_mesh", "mesh_shape_for", "lane_roster", "ShardedCryptoPlane"]


def __getattr__(name):
    if name in ("make_mesh", "mesh_shape_for", "lane_roster"):
        from plenum_tpu_torch.parallel import mesh
        return getattr(mesh, name)
    if name == "ShardedCryptoPlane":
        from plenum_tpu_torch.parallel.crypto_plane import ShardedCryptoPlane
        return ShardedCryptoPlane
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
