"""Closed-form cost accounting: ``analytics`` (a copy of ``repro.roofline.analytics``)."""
