"""The benchmark's harness: specs, frames, the timed window, tracing, the check."""
