"""The benchmark's harness: spec files, traffic, reference, yardstick."""
