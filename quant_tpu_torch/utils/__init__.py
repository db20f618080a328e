"""Device selection and timing helpers."""
