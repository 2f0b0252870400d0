"""Image file readers and writers (PNM, PGX, raw, BMP, TGA, PNG, TIFF) and
the decode's colour policy (`color`, `icc`), copies of the reference
package's `io/` on the host."""
