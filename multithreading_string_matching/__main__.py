from multithreading_string_matching.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
