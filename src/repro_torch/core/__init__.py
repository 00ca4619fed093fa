"""The port's engine: state, ingestion, relaxation, deletion, backends and
the stream driver, module for module beside ``repro.core``."""
