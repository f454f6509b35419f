"""Offline tools (the reference's tools/ directory): the port of the JAX
package's `tools/`, without OpenCV."""
