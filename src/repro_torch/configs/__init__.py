"""Architecture configs (the reference's ``ARCH_ID`` / ``FAMILY`` /
``CONFIG`` / ``REDUCED`` on the port's config classes), the shape
registry and the reduced-config smoke."""
