"""The plain reference that decides ``correct``: torch alone, float32."""
