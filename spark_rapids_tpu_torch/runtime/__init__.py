"""Device selection and description."""
