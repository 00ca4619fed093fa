"""sssp-del — the paper's own technique as the 11th selectable config.

Shapes are (vertex count, per-partition edge capacity): the total edge pool
scales with the mesh (shared-nothing, paper §3).  ``rmat24`` matches the
paper's RMAT(20) scaled to pod size; ``web_1b`` is a web-Google-like graph
at 1B+ edges (the 1000+-node design point)."""
import dataclasses

ARCH_ID = "sssp-del"
FAMILY = "sssp"


@dataclasses.dataclass(frozen=True)
class SSSPArchConfig:
    name: str
    num_vertices: int
    edges_per_part: int
    exchange: str = "allgather"   # paper-faithful; "delta" = beyond-paper
    delta_cap: int = 4096
    # Relaxation backend — one RelaxBackend name for BOTH engines
    # (core/backends/): "segment" = COO scatter-min (portable default);
    # "ellpack" = dense gather + row-min over the incrementally maintained
    # ELLPACK block (kernel K1's layout — bounded-degree fast path);
    # "sliced" = hub-aware hybrid (per-slice-width ELL + overflow COO lane)
    # for power-law in-degree graphs.  The sharded engine runs the same
    # backend per partition.
    relax_backend: str = "segment"
    ell_block_rows: int = 256
    ell_init_k: int = 8
    sliced_slice_rows: int = 256
    sliced_hub_k: int = 32
    sliced_init_k: int = 2

    def _backend_kw(self) -> dict:
        """Only forward knobs the selected backend accepts — construction
        validates that cross-backend knobs stay at their defaults."""
        kw = dict(relax_backend=self.relax_backend)
        if self.relax_backend == "ellpack":
            kw.update(ell_block_rows=self.ell_block_rows,
                      ell_init_k=self.ell_init_k)
        elif self.relax_backend == "sliced":
            kw.update(sliced_slice_rows=self.sliced_slice_rows,
                      sliced_hub_k=self.sliced_hub_k,
                      sliced_init_k=self.sliced_init_k)
        return kw

    def make_engine(self, *, edge_capacity: int | None = None,
                    source: int = 0,
                    sources: tuple[int, ...] | None = None,
                    partitions: int | None = None, mesh=None, **overrides):
        """Build a READY engine carrying this arch config's backend
        selection — the one entry point for both engines (lazy import keeps
        configs/ free of core dependencies).

        Single device by default; pass ``mesh=`` or ``partitions=`` for the
        sharded engine (its total pool defaults to this config's
        ``edges_per_part`` x P when ``edge_capacity`` is omitted).
        ``sources`` selects batched multi-source serving; ``source`` is
        then ignored.  ``overrides`` are engine knobs (``device="cpu"``
        among them: the engines default to the card)."""
        from repro_torch.core.factory import make_engine as _make
        kw = dict(self._backend_kw())
        if mesh is not None or partitions is not None:
            kw.update(exchange=self.exchange, delta_cap=self.delta_cap)
            if edge_capacity is None:
                P = partitions
                if P is None:
                    P = 1
                    for a in mesh.axis_names:
                        P *= mesh.shape[a]
                edge_capacity = self.edges_per_part * P
        elif edge_capacity is None:
            raise ValueError("edge_capacity is required for the "
                             "single-host engine")
        kw.update(overrides)
        return _make(num_vertices=self.num_vertices,
                     edge_capacity=edge_capacity, source=source,
                     sources=sources, partitions=partitions, mesh=mesh,
                     **kw)

    # -------------------------------------------------- deprecated shims
    # The config-object bridges predate make_engine; they remain as thin
    # shims so downstream pins keep working one release.
    def engine_config(self, *, edge_capacity: int, source: int,
                      sources: tuple[int, ...] | None = None, **overrides):
        """Deprecated: use ``make_engine`` (returns a ready engine) or
        construct ``EngineConfig`` directly."""
        import warnings

        from repro_torch.core.engine import EngineConfig
        warnings.warn("SSSPArchConfig.engine_config is deprecated; use "
                      "SSSPArchConfig.make_engine / repro_torch.make_engine",
                      DeprecationWarning, stacklevel=2)
        kw = dict(num_vertices=self.num_vertices,
                  edge_capacity=edge_capacity, source=source,
                  sources=sources, **self._backend_kw())
        kw.update(overrides)
        return EngineConfig(**kw)

    def sharded_engine_config(self, *, source: int,
                              sources: tuple[int, ...] | None = None,
                              **overrides):
        """Deprecated: use ``make_engine(partitions=...)`` /
        ``make_engine(mesh=...)``."""
        import warnings

        from repro_torch.core.dist_engine import ShardedEngineConfig
        warnings.warn("SSSPArchConfig.sharded_engine_config is deprecated; "
                      "use SSSPArchConfig.make_engine / "
                      "repro_torch.make_engine",
                      DeprecationWarning, stacklevel=2)
        kw = dict(num_vertices=self.num_vertices,
                  edges_per_part=self.edges_per_part, source=source,
                  exchange=self.exchange, delta_cap=self.delta_cap,
                  sources=sources, **self._backend_kw())
        kw.update(overrides)
        return ShardedEngineConfig(**kw)


CONFIG = SSSPArchConfig(name=ARCH_ID, num_vertices=1 << 24,
                        edges_per_part=1 << 20)
REDUCED = SSSPArchConfig(name=ARCH_ID + "-smoke", num_vertices=1 << 10,
                         edges_per_part=1 << 12)
