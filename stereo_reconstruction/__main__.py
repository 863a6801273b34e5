from stereo_reconstruction.cli import main

main()
