/* tap_poes.c — oracle stage-tap driver (test harness only).
 *
 * Links against the REFERENCE DSP library (built from /root/reference/common)
 * and runs the POES TIP chain with the exact parameters used by
 * POESTIPdemod/main.c, dumping the intermediate stream after every stage to
 * raw float32 files so the JAX implementation can be diffed stage-by-stage.
 *
 * This file is original test-harness code; the DSP blocks themselves are the
 * unmodified reference objects.
 */
#include <complex.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>

#include "wave.h"
#include "AGC.h"
#include "CarrierTrackPLL.h"
#include "LowPassFilter.h"
#include "GardenerClockRecovery.h"
#include "ManchesterDecode.h"

/* POESTIPdemod/main.c parameter block */
#define MAX_DEV      4500.0
#define PLL_ACQ      127.3240
#define PLL_TRK      10.3451
#define PLL_LOCKA    0.3979
#define PLL_THRESH   0.08
#define GDNR_LIM     0.1
#define GDNR_GAIN    3.0
#define BAUD         (8320*2+0.3)
#define AGC_ATK      79.5775
#define AGC_DCY      159.1549
#define LPF_FC       11000.0
#define LPF_ORDER    26

int ByteSyncOnSyncword(unsigned char *bitStreamIn, DECIMAL_TYPE *bitStreamInTime,
                       unsigned long nSamples, char *syncWord,
                       unsigned int syncWordLength, FILE *minorFrameFile);

static FILE *tap(const char *dir, const char *name) {
  char p[512];
  snprintf(p, sizeof p, "%s/%s", dir, name);
  FILE *f = fopen(p, "wb");
  if (!f) { perror(p); exit(1); }
  return f;
}

int main(int argc, char **argv) {
  if (argc < 3) { fprintf(stderr, "usage: tap_poes in.wav outdir [chunkSize]\n"); return 1; }
  unsigned long chunkSize = argc > 3 ? strtoul(argv[3], 0, 10) : 10000;

  FILE *in = fopen(argv[1], "rb");
  if (!in) { perror(argv[1]); return 1; }
  HEADER header = ReadWavHeader(in);
  DECIMAL_TYPE Fs = (DECIMAL_TYPE)header.sample_rate;
  int interp = (int)rint(150000.0 / Fs);
  int order = LPF_ORDER * interp;

  const char *dir = argv[2];
  FILE *f_iq   = tap(dir, "iq.c64");        /* complex input, interleaved re/im f32 */
  FILE *f_time = tap(dir, "time.f32");
  FILE *f_pll  = tap(dir, "pll.f32");
  FILE *f_lpf  = tap(dir, "lpf.f32");
  FILE *f_lpft = tap(dir, "lpf_time.f32");
  FILE *f_agc  = tap(dir, "agc.f32");
  FILE *f_sym  = tap(dir, "sym.f32");
  FILE *f_symt = tap(dir, "sym_time.f32");
  FILE *f_bit  = tap(dir, "bits.u8");
  FILE *f_bitt = tap(dir, "bit_time.f32");
  FILE *f_frm  = tap(dir, "frames.txt");

  DECIMAL_TYPE complex *wave = malloc(sizeof(*wave) * chunkSize);
  DECIMAL_TYPE *wtime = malloc(sizeof(DECIMAL_TYPE) * chunkSize);
  DECIMAL_TYPE *pllout = malloc(sizeof(DECIMAL_TYPE) * chunkSize);
  DECIMAL_TYPE *lpf = malloc(sizeof(DECIMAL_TYPE) * chunkSize * order);
  DECIMAL_TYPE *lpft = malloc(sizeof(DECIMAL_TYPE) * chunkSize * order);
  DECIMAL_TYPE *sym = malloc(sizeof(DECIMAL_TYPE) * chunkSize);
  unsigned char *bits = malloc(chunkSize);
  DECIMAL_TYPE *coef = malloc(sizeof(DECIMAL_TYPE) * order);
  MakeLPFIR(coef, order, LPF_FC, Fs * interp, interp);
  FILE *f_coef = tap(dir, "fir_coef.f32");
  fwrite(coef, sizeof(DECIMAL_TYPE), order, f_coef);
  fclose(f_coef);

  DECIMAL_TYPE normFactor = 0;
  unsigned long i = 0;
  int totalFrames = 0;
  while (!feof(in)) {
    unsigned long n = GetComplexWaveChunk(in, header, wave, wtime, chunkSize);
    if (i == 0) {
      normFactor = StaticGain(wave, n, 1.0);
      FILE *f_n = tap(dir, "normfactor.f32");
      fwrite(&normFactor, sizeof normFactor, 1, f_n);
      fclose(f_n);
    }
    i += n;
    fwrite(wave, sizeof(*wave), n, f_iq);
    fwrite(wtime, sizeof(DECIMAL_TYPE), n, f_time);

    CarrierTrackPLL(wave, pllout, NULL, n, Fs, MAX_DEV, PLL_THRESH,
                    PLL_LOCKA * (2.0 * M_PI / Fs), PLL_ACQ * (2.0 * M_PI / Fs),
                    PLL_TRK * (2.0 * M_PI / Fs));
    fwrite(pllout, sizeof(DECIMAL_TYPE), n, f_pll);

    LowPassFilterInterp(wtime, pllout, lpf, lpft, n, coef, order, interp);
    fwrite(lpf, sizeof(DECIMAL_TYPE), n * interp, f_lpf);
    fwrite(lpft, sizeof(DECIMAL_TYPE), n * interp, f_lpft);

    NormalizingAGC(lpf, n * interp, normFactor,
                   AGC_ATK * (2.0 * M_PI / (Fs * interp)),
                   AGC_DCY * (2.0 * M_PI / (Fs * interp)));
    fwrite(lpf, sizeof(DECIMAL_TYPE), n * interp, f_agc);

    unsigned long nSym = GardenerClockRecovery(lpf, lpft, n * interp, sym,
                                               Fs * interp, BAUD, GDNR_LIM, GDNR_GAIN);
    fwrite(sym, sizeof(DECIMAL_TYPE), nSym, f_sym);
    fwrite(lpft, sizeof(DECIMAL_TYPE), nSym, f_symt);

    unsigned long nBits = ManchesterDecode(sym, lpft, nSym, bits, 1.0);
    fwrite(bits, 1, nBits, f_bit);
    fwrite(lpft, sizeof(DECIMAL_TYPE), nBits, f_bitt);

    totalFrames += ByteSyncOnSyncword(bits, lpft, nBits, "1110110111100010000", 19, f_frm);
  }
  fprintf(stderr, "frames: %d\n", totalFrames);
  fclose(f_iq); fclose(f_time); fclose(f_pll); fclose(f_lpf); fclose(f_lpft);
  fclose(f_agc); fclose(f_sym); fclose(f_symt); fclose(f_bit); fclose(f_bitt);
  fclose(f_frm); fclose(in);
  return 0;
}
