"""ORB front end: extractor, Frame, Camera."""
